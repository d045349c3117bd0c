"""Recompression stability (port of
``imagecompression_adversarial_tpu/analysis/recompression.py``): run the
codec on its own output, rounded to 8 bits, ``repeats`` times, and report
the last cycle's bpp and the PSNR and MS-SSIM of the last output against
the original.  ``defend="ensemble"`` runs the self-ensemble in every cycle.
JAX's ``lax.scan`` over the cycles is a plain loop here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..defenses.self_ensemble import self_ensemble
from ..metrics import bpp_from_likelihoods, ms_ssim, psnr


def make_recompression_fn(model, repeats: int = 50, defend: Optional[str] = None) -> Callable:
    """``x -> {bpp, psnr, msim, msim_dB, bpp_trajectory}`` of an NCHW image
    after ``repeats`` cycles."""

    @torch.no_grad()
    def recompress(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        num_pixels = x.shape[2] * x.shape[3]
        im, bpps = x, []
        for _ in range(repeats):
            if defend == "ensemble":
                out = self_ensemble(model, im)
                x_hat, bpp = out["x_hat"], out["bpp"]
            else:
                result = model(im, quant_mode="dequantize")
                x_hat = result["x_hat"].clamp(0.0, 1.0)
                bpp = bpp_from_likelihoods(result["likelihoods"], num_pixels)
            im = torch.round(x_hat * 255.0) / 255.0  # the reference writes a PNG a cycle
            bpps.append(bpp)
        msim = ms_ssim(im, x)
        return {
            "bpp": bpps[-1],
            "psnr": psnr(im, x),
            "msim": msim,
            "msim_dB": -10.0 * torch.log10(1.0 - msim),
            "bpp_trajectory": torch.stack(bpps),
        }

    return recompress
