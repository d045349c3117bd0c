"""Scalar quality and rate metrics (port of
``imagecompression_adversarial_tpu/metrics/core.py``), on NCHW tensors."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Union

import numpy as np
import torch

from ..ops import shard

_LOG2 = math.log(2.0)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    return 10.0 * torch.log10((max_val ** 2) / mse(a, b))


def bpp_from_likelihoods(
    likelihoods: Union[Iterable[torch.Tensor], Dict[str, torch.Tensor]], num_pixels: int
) -> torch.Tensor:
    """Entropy-estimated bits per pixel: sum(-log2 p) / num_pixels.  Under
    a row shard (``ops/shard.py``) the sum runs over every shard and
    ``num_pixels``, this shard's count, is scaled to the image's."""
    if isinstance(likelihoods, dict):
        likelihoods = likelihoods.values()
    total = shard.row_sum(sum(torch.sum(torch.log(lik)) for lik in likelihoods))
    return total / (-_LOG2 * num_pixels * shard.row_count())


def vi(mse_in: torch.Tensor, mse_out: torch.Tensor) -> torch.Tensor:
    """The attack's headline metric, 10*log10(mse_out / mse_in), with both
    terms floored at 1e-20 so a no-op attack gives 0 dB."""
    return 10.0 * torch.log10(mse_out.clamp(min=1e-20) / mse_in.clamp(min=1e-20))


def vi_msim(msim_in: torch.Tensor, msim_out: torch.Tensor) -> torch.Tensor:
    """MS-SSIM analog of VI, 10*log10((1 - msim_out) / (1 - msim_in)), with
    both complements floored at 1e-4."""
    return 10.0 * torch.log10((1.0 - msim_out).clamp(min=1e-4) / (1.0 - msim_in).clamp(min=1e-4))


# BT.601 full-range RGB -> YUV, the chroma rows offset by 128/255
_RGB2YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.169, -0.331, 0.499],
        [0.499, -0.418, -0.0813],
    ],
    np.float32,
)
_YUV_OFFSET = np.array([0.0, 128.0 / 255.0, 128.0 / 255.0], np.float32)


def rgb2yuv444(x: torch.Tensor) -> torch.Tensor:
    """NCHW RGB in [0, 1] -> YUV444 (BT.601, chroma offset +0.5)."""
    m = torch.from_numpy(_RGB2YUV).to(x)
    offset = torch.from_numpy(_YUV_OFFSET).to(x).reshape(1, 3, 1, 1)
    return torch.einsum("oc,nchw->nohw", m, x) + offset


def mse_yuv444(a: torch.Tensor, b: torch.Tensor, weights=(6.0, 1.0, 1.0)) -> torch.Tensor:
    """6:1:1-weighted YUV MSE of two NCHW RGB batches."""
    w = torch.tensor(weights, dtype=a.dtype, device=a.device)
    per_ch = torch.mean((rgb2yuv444(a) - rgb2yuv444(b)) ** 2, dim=(0, 2, 3))
    return torch.sum(per_ch * w / torch.sum(w))
