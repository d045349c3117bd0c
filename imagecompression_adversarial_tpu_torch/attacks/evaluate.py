"""Post-attack evaluation (port of
``imagecompression_adversarial_tpu/attacks/evaluate.py``): the codec on the
adversarial input in round-quantization mode, or the defense given as
``defend_fn``, estimated bpp, input/output MSE and MS-SSIM, and VI."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..metrics import bpp_from_likelihoods, ms_ssim, vi, vi_msim
from ..ops import shard


@torch.no_grad()
def evaluate(
    model,
    im_adv,
    im_s,
    output_s,
    clamp: bool = True,
    defend_fn: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Evaluate an adversarial input (NCHW) against the clean output.

    ``defend_fn(x) -> (x_hat, likelihoods)`` replaces the codec's forward;
    a likelihoods dict holding ``'__bpp__'`` carries a rate the defense has
    already reduced (the self-ensemble's winner).

    Under a row shard (``ops/shard.py``) the rate and the MSEs are the
    whole image's, MS-SSIM gathers the rows once, and ``im_`` and
    ``output_`` stay this shard's rows."""
    im_ = im_adv.clamp(0.0, 1.0) if clamp else im_adv
    if defend_fn is not None:
        x_hat, likelihoods = defend_fn(im_)
    else:
        result = model(im_, quant_mode="dequantize")
        x_hat, likelihoods = result["x_hat"], result["likelihoods"]
    output_ = x_hat.clamp(0.0, 1.0) if clamp else x_hat
    if isinstance(likelihoods, dict) and "__bpp__" in likelihoods:
        bpp = likelihoods["__bpp__"]
    else:
        bpp = bpp_from_likelihoods(likelihoods, im_adv.shape[2] * im_adv.shape[3])
    mse_in = shard.mean((im_ - im_s) ** 2)
    mse_out = shard.mean((output_ - output_s) ** 2)
    g = shard.gather_rows
    msim_in = ms_ssim(g(im_), g(im_s))
    msim_out = ms_ssim(g(output_), g(output_s))
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
