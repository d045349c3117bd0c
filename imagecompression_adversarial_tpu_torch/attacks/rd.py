"""The canonical RD distortion attack (port of
``imagecompression_adversarial_tpu/attacks/rd.py``, non-split and
non-defended).

Each step clips the noise to the L-inf ball through the gated bounds, then
the input to [0, 1] (not for the debug fixture); while the input MSE is
over budget the loss is that MSE, otherwise it is
``1 - MSE(out, out_clean)`` through the quantization-free path.  Adam on the noise with the MultiStepLR schedule;
the final evaluation uses real rounding.  The loop runs eagerly: one
forward and one backward a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..metrics import bpp_from_likelihoods, ms_ssim
from ..ops.bounds import bound_clip
from .common import AdamOnNoise, RDAttackConfig, init_noise, multistep_lr_schedule
from .evaluate import evaluate


def _adversarial_input(x, noise_c, cfg: RDAttackConfig):
    """``x + noise_c``, clipped to [0, 1] through the gated bounds unless
    the codec is the debug fixture."""
    return x + noise_c if cfg.debug_model else bound_clip(x + noise_c, 0.0, 1.0)


def _attack_loss(model, x, output_s, noise, cfg: RDAttackConfig, phase: bool):
    """Two-phase RD attack loss; returns ``(loss, (loss_i, loss_o))``.

    With ``phase`` the output is the phase-space synthesis and ``output_s``
    its clean counterpart: MSE is invariant under the permutation back to
    full resolution, so the loss, its gradient and the trajectory are the
    full-resolution ones.
    """
    eps = cfg.epsilon / 255.0
    im_in = _adversarial_input(x, bound_clip(noise, -eps, eps), cfg)
    loss_i = torch.mean((x - im_in) ** 2)
    zero = torch.zeros_like(loss_i)

    if cfg.two_phase_impl == "cond" and bool(loss_i > cfg.noise_threshold):
        if cfg.att_metric == "ms-ssim":
            return 1.0 - ms_ssim(x, im_in), (loss_i, zero)
        return loss_i, (loss_i, zero)

    if phase:
        x_ = model.g_s_phase(model.g_a(im_in))
    else:
        x_ = model(im_in, quant_mode="none")["x_hat"]
    output_ = bound_clip(x_, 0.0, 1.0) if cfg.clamp else x_
    if cfg.att_metric == "ms-ssim":
        loss_o = ms_ssim(output_, output_s)
    else:
        loss_o = 1.0 - torch.mean((output_s - output_) ** 2)
    if cfg.two_phase_impl == "cond":
        return loss_o, (loss_i, loss_o)
    over = loss_i > cfg.noise_threshold
    return torch.where(over, loss_i, loss_o), (loss_i, torch.where(over, zero, loss_o))


def _resolve(model, cfg: RDAttackConfig) -> RDAttackConfig:
    """Check the loss settings and settle ``phase_space_loss=None`` (auto):
    on iff the attack is the plain L2 one on a codec other than the debug
    fixture and the codec has an exact phase synthesis."""
    if cfg.two_phase_impl not in ("cond", "select"):
        raise ValueError(f"two_phase_impl={cfg.two_phase_impl!r} not in ('cond', 'select')")
    if cfg.two_phase_impl == "select" and cfg.att_metric == "ms-ssim":
        raise ValueError("two_phase_impl='select' supports the L2 att_metric only")
    supported = bool(getattr(model, "supports_phase_synthesis", False))
    if cfg.phase_space_loss is None:
        eligible = cfg.att_metric != "ms-ssim" and not cfg.pad and not cfg.debug_model
        return dataclasses.replace(cfg, phase_space_loss=eligible and supported)
    if cfg.phase_space_loss and not supported:
        raise ValueError(
            f"phase_space_loss=True but {type(model).__name__} has no exact "
            "phase-space synthesis"
        )
    if cfg.phase_space_loss and (cfg.att_metric == "ms-ssim" or cfg.pad):
        raise ValueError("phase_space_loss supports the plain L2 attack only")
    return cfg


def make_attack_fn(model, cfg: RDAttackConfig) -> Callable[..., Dict[str, Any]]:
    """Build ``attack(x, generator=None) -> results`` for a ``(1, 3, H, W)``
    image on the model's device.  Results hold tensors: ``im_``,
    ``output_``, ``bpp``, ``bpp_ori``, MSEs, MS-SSIMs, ``vi``, ``vi_msim``,
    ``output_s``, ``loss_i_final`` and ``loss_o_final``."""
    cfg = _resolve(model, cfg)
    lrs = multistep_lr_schedule(cfg.steps, cfg.lr, cfg.lr_milgamma).tolist()

    def attack(x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            if cfg.pad:
                p = cfg.pad
                result_s = model(F.pad(x, (p, p, p, p), mode=cfg.padding_mode), "dequantize")
                output_s = result_s["x_hat"][:, :, p:-p, p:-p].clamp(0.0, 1.0)
            else:
                result_s = model(x, quant_mode="dequantize")
                output_s = result_s["x_hat"].clamp(0.0, 1.0) if cfg.clamp else result_s["x_hat"]
            bpp_ori = bpp_from_likelihoods(result_s["likelihoods"], x.shape[2] * x.shape[3])
            if cfg.phase_space_loss:
                ref = model.g_s_phase(result_s[model.phase_reference_latent])
                loss_ref = ref.clamp(0.0, 1.0) if cfg.clamp else ref
            else:
                loss_ref = output_s

        noise = init_noise(tuple(x.shape), cfg, generator, x.device)
        noise = noise.contiguous(memory_format=torch.channels_last)
        opt = AdamOnNoise(noise)
        for lr in lrs:
            noise.requires_grad_(True)
            loss, _ = _attack_loss(model, x, loss_ref, noise, cfg, cfg.phase_space_loss)
            (grad,) = torch.autograd.grad(loss, noise)
            noise = noise.detach()
            opt.step(noise, grad, lr)

        with torch.no_grad():
            _, (loss_i_final, loss_o_final) = _attack_loss(
                model, x, loss_ref, noise, cfg, cfg.phase_space_loss
            )
            eps = cfg.epsilon / 255.0
            im_in = _adversarial_input(x, noise.clamp(-eps, eps), cfg)
        ev = evaluate(model, im_in, x, output_s, clamp=cfg.clamp)
        ev.update(
            {
                "output_s": output_s,
                "bpp_ori": bpp_ori,
                "loss_i_final": loss_i_final,
                "loss_o_final": loss_o_final,
            }
        )
        return ev

    return attack
