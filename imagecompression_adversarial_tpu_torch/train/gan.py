"""GAN losses and the alternating GAN step of the HiFiC-family codec (port
of ``imagecompression_adversarial_tpu/train/gan.py``).

The generator's total is ``0.14 * bpp + k_M * 255^2 * MSE + k_P * (1 -
MS-SSIM(clip(x_hat))) + beta * g_adv`` with non-saturating (sigmoid
cross-entropy) GAN losses; ``perceptual_fn`` replaces the MS-SSIM term.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..metrics import ms_ssim
from .loss import rate_distortion_loss
from .step import _grads


def non_saturating_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(fake_logits, torch.ones_like(fake_logits))


def non_saturating_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    real = F.binary_cross_entropy_with_logits(real_logits, torch.ones_like(real_logits))
    fake = F.binary_cross_entropy_with_logits(fake_logits, torch.zeros_like(fake_logits))
    return real + fake


def hific_generator_loss(
    result: Dict,
    target: torch.Tensor,
    fake_logits: torch.Tensor,
    lmbda_rate: float = 0.14,
    k_m: float = 0.075 * 2 ** -5,
    k_p: float = 1.0,
    beta: float = 0.15,
    perceptual_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, logs) of the HiFiC generator objective on an NCHW batch."""
    bpp = rate_distortion_loss(result, target, lmbda=0.0, metric="mse")["bpp_loss"]
    mse = torch.mean((result["x_hat"] - target) ** 2)
    if perceptual_fn is None:
        perceptual = 1.0 - ms_ssim(result["x_hat"].clamp(0.0, 1.0), target)
    else:
        perceptual = perceptual_fn(result["x_hat"], target)
    g_adv = non_saturating_g_loss(fake_logits)
    total = lmbda_rate * bpp + k_m * (255.0 ** 2) * mse + k_p * perceptual + beta * g_adv
    return total, {"bpp": bpp, "mse": mse, "perceptual": perceptual, "g_adv": g_adv,
                   "loss": total}


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def make_gan_train_step(codec, disc, g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer):
    """``step(batch, generator) -> logs``: one generator step, then one
    discriminator step, in JAX's order.

    * G: the codec's noise-quantized forward (its noise drawn from
      ``generator``); the discriminator, with its parameters and stats as
      they were, scores ``clip(x_hat)`` given ``y_hat`` (not detached, so
      the codec also gets a gradient through ``latent_proj``); its new
      spectral-norm stats are thrown away.  ``g_opt`` updates every codec
      parameter (no clip, no aux optimizer).
    * D: the real pass on ``(batch, y_hat)`` updates the stats, the fake
      pass on ``(clip(x_hat), y_hat)``, both detached, starts from them and
      updates them again; ``d_opt`` updates the discriminator.

    Logs are detached device tensors: the generator's and ``d_loss``.
    """
    g_params = list(codec.parameters())
    d_params = list(disc.parameters())

    def step(batch: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        result = codec(batch, quant_mode="noise", generator=generator)
        x_hat = result["x_hat"].clamp(0.0, 1.0)
        fake_logits = disc(x_hat, result["y_hat"], update_stats=False)
        g_loss, logs = hific_generator_loss(result, batch, fake_logits)
        _apply(g_opt, g_params, _grads(g_loss, g_params))

        y_hat = result["y_hat"].detach()
        real_logits = disc(batch, y_hat, update_stats=True)
        fake_logits = disc(x_hat.detach(), y_hat, update_stats=True)
        d_loss = non_saturating_d_loss(real_logits, fake_logits)
        _apply(d_opt, d_params, _grads(d_loss, d_params))

        out = {k: v.detach() for k, v in logs.items()}
        out["d_loss"] = d_loss.detach()
        return out

    return step
