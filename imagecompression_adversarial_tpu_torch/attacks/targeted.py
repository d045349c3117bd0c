"""Targeted and ROI attacks (port of
``imagecompression_adversarial_tpu/attacks/targeted.py``): steer the
reconstruction toward a target image, inside a box, or toward a
classifier's label.

* targeted: ``loss_o = MSE(output, target)`` (or L1), minimized;
* ROI: an ``(x0, x1, y0, y1)`` box (rows ``y0:y1``, columns ``x0:x1``)
  splits the image into target and background, weighted by ``lamb_tar``,
  ``lamb_bkg_in`` and ``lamb_bkg_out``;
* classifier: cross-entropy of ``classifier_logits_fn(output)`` toward
  ``target_label``;
* neither: the untargeted ``1 - MSE(x, output)``.

Adam on the noise (range 0.5) with the two-phase switch
``loss_i >= noise_threshold`` (``>=``, where the RD attack has ``>``),
taken with ``torch.where``: both losses run every step, with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..metrics import bpp_from_likelihoods
from ..ops.bounds import bound_clip
from .common import AdamOnNoise, multistep_lr_schedule
from .evaluate import evaluate


@dataclasses.dataclass(frozen=True)
class TargetedAttackConfig:
    steps: int = 1001
    lr: float = 0.01
    noise_threshold: float = 1e-4
    noise_range: float = 0.5
    att_metric: str = "L2"  # 'L2' | 'L1' | 'masked'
    clamp: bool = True
    lamb_tar: float = 1.0
    lamb_bkg_in: float = 1.0
    lamb_bkg_out: float = 1.0
    mask_loc: Optional[Tuple[int, int, int, int]] = None  # x0, x1, y0, y1
    lr_milgamma: float = 0.33


def roi_masks(shape, mask_loc, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mask_tar, mask_bkg)`` of an NCHW ``shape`` from an ``(x0, x1, y0,
    y1)`` box, indexed ``[y0:y1, x0:x1]``."""
    x0, x1, y0, y1 = mask_loc
    mask_bkg = torch.ones(shape, device=device)
    mask_bkg[:, :, y0:y1, x0:x1] = 0.0
    return 1.0 - mask_bkg, mask_bkg


def make_targeted_attack_fn(
    model,
    cfg: TargetedAttackConfig,
    classifier_logits_fn: Optional[Callable] = None,
    target_label: Optional[int] = None,
):
    """``attack(x, target_image=None) -> results`` for a ``(1, 3, H, W)``
    image; results add ``loss_i_final`` and ``loss_o_final``."""
    lrs = multistep_lr_schedule(cfg.steps, cfg.lr, cfg.lr_milgamma).tolist()
    r = cfg.noise_range

    def attack(x: torch.Tensor, target_image: Optional[torch.Tensor] = None):
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            result_s = model(x, quant_mode="dequantize")
            output_s = result_s["x_hat"].clamp(0.0, 1.0)
            bpp_ori = bpp_from_likelihoods(result_s["likelihoods"], x.shape[2] * x.shape[3])
        if cfg.mask_loc is not None:
            mask_tar, mask_bkg = roi_masks(x.shape, cfg.mask_loc, x.device)
        else:
            mask_tar, mask_bkg = torch.ones_like(x), torch.zeros_like(x)
        if cfg.att_metric == "L1":
            diff_fn = lambda a, b: torch.abs(a - b)  # noqa: E731
        else:
            diff_fn = lambda a, b: (a - b) ** 2  # noqa: E731

        def loss_fn(noise):
            im_in = bound_clip(x + bound_clip(noise, -r, r), 0.0, 1.0)
            x_hat = model(im_in, quant_mode="none")["x_hat"]
            output_ = bound_clip(x_hat, 0.0, 1.0) if cfg.clamp else x_hat
            diff_in = diff_fn(im_in, x)
            loss_i = (cfg.lamb_tar * torch.mean(diff_in * mask_tar)
                      + cfg.lamb_bkg_in * torch.mean(diff_in * mask_bkg))
            if classifier_logits_fn is not None:
                logits = classifier_logits_fn(output_)
                label = torch.full((logits.shape[0],), int(target_label), device=logits.device)
                loss_o = F.cross_entropy(logits, label)
            elif target_image is not None:
                loss_o = (cfg.lamb_tar * torch.mean(diff_fn(output_, target_image) * mask_tar)
                          + cfg.lamb_bkg_out * torch.mean(diff_fn(output_, output_s) * mask_bkg))
            else:
                loss_o = 1.0 - torch.mean(diff_fn(x, output_))
            return torch.where(loss_i >= cfg.noise_threshold, loss_i, loss_o), (loss_i, loss_o)

        noise = torch.zeros_like(x)
        opt = AdamOnNoise(noise)
        for lr in lrs:
            noise.requires_grad_(True)
            loss, _ = loss_fn(noise)
            (grad,) = torch.autograd.grad(loss, noise)
            noise = noise.detach()
            opt.step(noise, grad, lr)
        with torch.no_grad():
            _, (loss_i_final, loss_o_final) = loss_fn(noise)
            im_in = torch.clamp(x + noise.clamp(-r, r), 0.0, 1.0)
        ev = evaluate(model, im_in, x, output_s, clamp=cfg.clamp)
        ev.update({"output_s": output_s, "bpp_ori": bpp_ori,
                   "loss_i_final": loss_i_final, "loss_o_final": loss_o_final})
        return ev

    return attack
