"""Random-noise and blur robustness evaluation (port of
``imagecompression_adversarial_tpu/analysis/random_noise.py``).

* ``make_noise_eval_fn``: Gaussian noise of a given power on the input;
  the amplification ``10 log10(err_out / noise_power)``, bpp and PSNR.
  The noise comes from a ``torch.Generator`` the caller seeds (the CLI
  with the image's index, where JAX uses ``PRNGKey(index)``), so the two
  packages draw different noise.
* ``calibrated_blur``: a 5x5 Gaussian blur (reflect padding) whose sigma
  is annealed down from 5.0 in steps of 0.005 until the blurred image's MSE
  is within 1% of the budget; each step reads the MSE on the host, as the
  reference does.
* ``make_deblur_eval_fn``: how far the codec repairs or worsens a blurred
  input against its sharp original.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics import bpp_from_likelihoods


def gaussian_noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise of ``x``'s shape from ``generator`` (the one
    draw of ``make_noise_eval_fn``)."""
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def make_noise_eval_fn(model) -> Callable:
    """``(x, generator, noise_power) -> {vi_noise, bpp, bpp_ori, psnr}`` of
    an NCHW image."""

    @torch.no_grad()
    def eval_fn(x: torch.Tensor, generator: torch.Generator,
                noise_power: float) -> Dict[str, torch.Tensor]:
        noise = float(np.sqrt(noise_power)) * gaussian_noise(x, generator)
        im_in = torch.clamp(x + noise, 0.0, 1.0)
        res_ori = model(x, quant_mode="dequantize")
        res = model(im_in, quant_mode="dequantize")
        x_hat = res["x_hat"].clamp(0.0, 1.0)
        x_hat_ori = res_ori["x_hat"].clamp(0.0, 1.0)
        num_pixels = x.shape[2] * x.shape[3]
        err_out = torch.mean((x_hat_ori - x_hat) ** 2)
        return {
            "vi_noise": 10.0 * torch.log10(err_out / torch.mean(noise ** 2)),
            "bpp": bpp_from_likelihoods(res["likelihoods"], num_pixels),
            "bpp_ori": bpp_from_likelihoods(res_ori["likelihoods"], num_pixels),
            "psnr": -10.0 * torch.log10(torch.mean((x_hat - x) ** 2)),
        }

    return eval_fn


def _gaussian_blur_kernel(sigma: float, size: int = 5) -> np.ndarray:
    c = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(c ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float, size: int = 5) -> torch.Tensor:
    """Depthwise ``size`` x ``size`` Gaussian blur of an NCHW batch, reflect
    padding (torchvision's ``GaussianBlur``)."""
    c = x.shape[1]
    kern = torch.from_numpy(_gaussian_blur_kernel(sigma, size)).to(x)
    pad = size // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(xp, kern.expand(c, 1, size, size), groups=c)


@torch.no_grad()
def calibrated_blur(x: torch.Tensor, target_mse: float, sigma0: float = 5.0,
                    step: float = 0.005) -> Tuple[torch.Tensor, float]:
    """Anneal sigma down from ``sigma0`` until the blurred image's MSE is at
    most 1.01 x ``target_mse`` (or sigma reaches ``step``): (blurred, sigma)."""
    sigma = sigma0
    im_blur = torch.clamp(gaussian_blur(x, sigma), 0.0, 1.0)
    while float(torch.mean((im_blur - x) ** 2)) > target_mse * 1.01 and sigma > step:
        sigma -= step
        im_blur = torch.clamp(gaussian_blur(x, sigma), 0.0, 1.0)
    return im_blur, sigma


def make_deblur_eval_fn(model) -> Callable:
    """``(im_blur, im_sharp) -> {dpsnr, bpp, psnr_out}``: the blurred
    input's PSNR minus the reconstruction's, both against the sharp image."""

    @torch.no_grad()
    def eval_fn(im_blur: torch.Tensor, im_sharp: torch.Tensor) -> Dict[str, torch.Tensor]:
        res = model(im_blur, quant_mode="dequantize")
        y = res["x_hat"].clamp(0.0, 1.0)
        bpp = bpp_from_likelihoods(res["likelihoods"], im_blur.shape[2] * im_blur.shape[3])
        psnr_blur = -10.0 * torch.log10(torch.mean((im_blur - im_sharp) ** 2))
        psnr_out = -10.0 * torch.log10(torch.mean((y - im_sharp) ** 2))
        return {"dpsnr": psnr_blur - psnr_out, "bpp": bpp, "psnr_out": psnr_out}

    return eval_fn
