"""Patch attack helpers (port of
``imagecompression_adversarial_tpu/attacks/patch.py``): the local VI map
over all ``patch x patch`` windows at ``stride`` and the worst patch.

The per-window MSEs are window means of the squared-difference image
(``avg_pool2d``, VALID), averaged over channels, so no unfolded tensor is
formed.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _box_mean(sq_err: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Mean over ``size x size`` windows at ``stride`` and over batch and
    channels: ``(newH, newW)``."""
    return F.avg_pool2d(sq_err, size, stride).mean(dim=(0, 1))


def local_vi_map(im_adv, output_adv, im_s, output_s, patch: int = 64, stride: int = 2,
                 border: int = 10) -> torch.Tensor:
    """Per-window ratio ``mse_out / mse_in`` with a zeroed ``border``."""
    mse_in = _box_mean((im_adv - im_s) ** 2, patch, stride)
    mse_out = _box_mean((output_adv - output_s) ** 2, patch, stride)
    vi = mse_out / (mse_in + 1e-20)
    mask = torch.zeros_like(vi)
    mask[border:-border, border:-border] = 1.0
    return vi * mask


def extract_worst_patch(im_adv, output_adv, im_s, output_s, patch: int = 64,
                        stride: int = 2) -> Dict[str, torch.Tensor]:
    """Slice the window of highest local VI (first in row-major order among
    equals) out of all four NCHW images."""
    vi = local_vi_map(im_adv, output_adv, im_s, output_s, patch, stride)
    flat = int(torch.argmax(vi))
    iy, ix = divmod(flat, vi.shape[1])
    y0, x0 = iy * stride, ix * stride

    def crop(img):
        return img[:, :, y0:y0 + patch, x0:x0 + patch]

    return {
        "patch_adv": crop(im_adv),
        "patch_outadv": crop(output_adv),
        "patch_s": crop(im_s),
        "patch_outs": crop(output_s),
        "vi_value": vi[iy, ix],
        "location": torch.tensor([y0, x0]),
    }
