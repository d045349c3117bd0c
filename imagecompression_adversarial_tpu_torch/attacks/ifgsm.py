"""Sign-gradient attacks: I-FGSM/BIM, PGD, MI-FGSM (port of
``imagecompression_adversarial_tpu/attacks/ifgsm.py``).

The objective is the output distortion ``MSE(out, out_clean)`` through the
quantization-free path, ascended by its input gradient:

* BIM: ``im += (eps / steps) * sign(grad)``;
* PGD: BIM from a uniform(+-eps) start, clamped to [0, 1];
* MI-FGSM: momentum ``g += grad / ||grad||_1``, step ``alpha * sign(g)``,
  then a [0, 1] clamp;

and every step projects back into the eps-ball around the clean image.  A
gradient component within float noise of 0 may take the other sign in
another implementation and move its pixel by 2 alpha, so two runs agree
pixel for pixel only up to such flips.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..metrics import bpp_from_likelihoods
from .evaluate import evaluate


@dataclasses.dataclass(frozen=True)
class IFGSMConfig:
    steps: int = 101
    epsilon: float = 16.0  # /255 L-inf budget
    random_start: bool = False  # PGD
    momentum: bool = False  # MI-FGSM
    clamp: bool = True
    # loss in the phase space of the last layer (the MSE, its gradient and
    # every step are the same); None = on where the codec has one
    phase_space_loss: Optional[bool] = None


def random_start(x: torch.Tensor, eps: float, generator: torch.Generator) -> torch.Tensor:
    """PGD's start: ``x`` plus uniform(-eps, eps) noise, clamped to [0, 1]."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.clamp(x + (2.0 * u - 1.0) * eps, 0.0, 1.0)


def sign_step(im_adv, g, grad, x, alpha: float, eps: float, momentum: bool):
    """One step: ``(im_adv, g)`` from the loss gradient ``grad``."""
    if momentum:
        g = g + grad / torch.sum(torch.abs(grad))
        im_adv = torch.clamp(im_adv + alpha * torch.sign(g), 0.0, 1.0)
    else:
        im_adv = im_adv + alpha * torch.sign(grad)
    return torch.clamp(im_adv, x - eps, x + eps), g


def make_ifgsm_fn(model, cfg: IFGSMConfig):
    """``attack(x, generator=None) -> results`` for a ``(1, 3, H, W)`` image;
    PGD draws its start from ``generator``."""
    eps = cfg.epsilon / 255.0
    alpha = eps / cfg.steps
    supported = bool(getattr(model, "supports_phase_synthesis", False))
    use_phase = supported if cfg.phase_space_loss is None else cfg.phase_space_loss
    if use_phase and not supported:
        raise ValueError(f"phase_space_loss=True but {type(model).__name__} has no exact "
                         "phase-space synthesis")

    def attack(x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            result_s = model(x, quant_mode="dequantize")
            output_s = result_s["x_hat"].clamp(0.0, 1.0)
            bpp_ori = bpp_from_likelihoods(result_s["likelihoods"], x.shape[2] * x.shape[3])
            if use_phase:
                loss_ref = model.g_s_phase(result_s[model.phase_reference_latent]).clamp(0.0, 1.0)
            else:
                loss_ref = output_s
        if cfg.random_start:
            if generator is None:
                raise ValueError("the PGD random start needs a torch.Generator")
            im_adv = random_start(x, eps, generator)
        else:
            im_adv = x
        g = torch.zeros_like(x)
        for _ in range(cfg.steps):
            im = im_adv.detach().requires_grad_(True)
            out = model.g_s_phase(model.g_a(im)) if use_phase else model(im, quant_mode="none")["x_hat"]
            (grad,) = torch.autograd.grad(torch.mean((loss_ref - out) ** 2), im)
            with torch.no_grad():
                im_adv, g = sign_step(im_adv, g, grad, x, alpha, eps, cfg.momentum)
        ev = evaluate(model, im_adv, x, output_s, clamp=cfg.clamp)
        ev.update({"output_s": output_s, "bpp_ori": bpp_ori})
        return ev

    return attack


def best_of_multistart(attack_fn, x: torch.Tensor, generator: torch.Generator, starts: int):
    """Run ``starts`` attacks one after the other, each drawing its start
    from ``generator``, and keep the highest-vi result (the first of
    equals)."""
    best_vi, best_res = -float("inf"), None
    for _ in range(starts):
        res = attack_fn(x, generator)
        v = float(res["vi"])
        if v > best_vi:
            best_vi, best_res = v, res
    return best_res
