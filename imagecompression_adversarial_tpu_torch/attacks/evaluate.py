"""Post-attack evaluation (port of
``imagecompression_adversarial_tpu/attacks/evaluate.py`` without the
defense hook): the codec on the adversarial input in round-quantization
mode, estimated bpp, input/output MSE and MS-SSIM, and VI."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..metrics import bpp_from_likelihoods, ms_ssim, vi, vi_msim


@torch.no_grad()
def evaluate(model, im_adv, im_s, output_s, clamp: bool = True) -> Dict[str, Any]:
    """Evaluate an adversarial input (NCHW) against the clean output."""
    im_ = im_adv.clamp(0.0, 1.0) if clamp else im_adv
    result = model(im_, quant_mode="dequantize")
    x_hat = result["x_hat"]
    output_ = x_hat.clamp(0.0, 1.0) if clamp else x_hat
    bpp = bpp_from_likelihoods(result["likelihoods"], im_adv.shape[2] * im_adv.shape[3])
    mse_in = torch.mean((im_ - im_s) ** 2)
    mse_out = torch.mean((output_ - output_s) ** 2)
    msim_in = ms_ssim(im_, im_s)
    msim_out = ms_ssim(output_, output_s)
    return {
        "im_": im_,
        "output_": output_,
        "bpp": bpp,
        "mse_in": mse_in,
        "mse_out": mse_out,
        "msim_in": msim_in,
        "msim_out": msim_out,
        "vi": vi(mse_in, mse_out),
        "vi_msim": vi_msim(msim_in, msim_out),
    }
