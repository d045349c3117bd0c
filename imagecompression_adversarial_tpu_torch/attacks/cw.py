"""Carlini & Wagner-style constrained attack with double bisection (port of
``imagecompression_adversarial_tpu/attacks/cw.py``).

* Joint loss ``loss_i + c * loss_o`` with ``loss_o = 1 - MSE(out,
  out_clean)``; ``c`` counts as 0 at any step whose output distortion is
  already over 1.1x the target level (a ``torch.where``, no host sync).
* Inner bisection of ``c`` in ``[0, lamb_attack]``: ``search_steps``
  rounds (``fast``: until ``|c_r - c_l| <= c_tol``, at most 4x as many),
  each ``steps`` Adam iterations on a noise that persists across rounds;
  ``c_l``/``c_r`` move by whether the distortion reached 99% of the target.
* Outer bisection of the target level in ``[noise_threshold, 0.1]``
  toward the input budget, with an early stop once the input loss settles
  near it; each outer round restarts from zero noise and a fresh Adam, and
  the result is the last round's input.
* Not in ``fast``: a bisection on a cap of ``|noise|`` until the capped
  noise's MSE meets the budget (to 1/256).

The bisections run on the host, one sync a round, in float32 arithmetic
as the reference's scalars are; ``decisions`` in the result records them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..metrics import bpp_from_likelihoods
from ..ops.bounds import bound_clip
from .common import AdamOnNoise
from .evaluate import evaluate

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class CWAttackConfig:
    steps: int = 101  # Adam iterations per bisection round
    lr: float = 0.01
    noise_threshold: float = 1e-4  # input budget (`-noise`)
    epsilon: float = 16.0  # /255 clip on the noise variable
    lamb_attack: float = 0.2  # initial c upper bound (`-la`)
    search_steps: int = 20  # bisection rounds (`-ssteps`)
    clamp: bool = True
    fast: bool = False  # run the inner bisection to convergence
    c_tol: float = 1e-4  # fast: tolerance on |c_r - c_l|


def make_cw_attack_fn(model, cfg: CWAttackConfig):
    """``attack(x) -> results`` for a ``(1, 3, H, W)`` image; results add
    ``loss_i_final``, ``outer_rounds`` and ``decisions`` (a list with one
    dict an outer round: its level, its inner rounds' ``reached`` flags and
    whether its input loss was ``over`` the budget)."""
    eps_inf = cfg.epsilon / 255.0
    thr = f32(cfg.noise_threshold)

    def attack(x: torch.Tensor) -> Dict[str, Any]:
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            result_s = model(x, quant_mode="dequantize")
            output_s = result_s["x_hat"].clamp(0.0, 1.0)
            bpp_ori = bpp_from_likelihoods(result_s["likelihoods"], x.shape[2] * x.shape[3])

        def cw_loss(noise, c, level):
            im_in = bound_clip(x + bound_clip(noise, -eps_inf, eps_inf), 0.0, 1.0)
            loss_i = torch.mean((x - im_in) ** 2)
            output_ = bound_clip(model(im_in, quant_mode="none")["x_hat"], 0.0, 1.0)
            loss_o = 1.0 - torch.mean((output_s - output_) ** 2)
            c_eff = torch.where(1.0 - loss_o > float(level * f32(1.1)), 0.0, float(c))
            return loss_i + c_eff * loss_o, (loss_i, loss_o)

        def adam_round(noise, opt, c, level):
            for _ in range(cfg.steps):
                noise.requires_grad_(True)
                loss, _ = cw_loss(noise, c, level)
                (grad,) = torch.autograd.grad(loss, noise)
                noise = noise.detach()
                opt.step(noise, grad, cfg.lr)
            with torch.no_grad():
                _, (loss_i, loss_o) = cw_loss(noise, c, level)
            return noise, f32(loss_i.item()), f32(loss_o.item())

        def search_noise(level, record: List[bool]):
            noise = torch.zeros_like(x)
            opt = AdamOnNoise(noise)
            c_l, c_r = f32(0.0), f32(cfg.lamb_attack)
            c = c_r
            loss_i = loss_o = f32(0.0)
            it = 0

            def more():
                if cfg.fast:
                    return abs(c_r - c_l) > f32(cfg.c_tol) and it < cfg.search_steps * 4
                return it < cfg.search_steps

            while more():
                noise, loss_i, loss_o = adam_round(noise, opt, c, level)
                reached = bool(f32(1.0) - loss_o < f32(f32(0.99) * level))
                record.append(reached)
                c_l, c_r = (c, c_r) if reached else (c_l, c)
                c = f32((c_r + c_l) / f32(2.0))
                it += 1
            with torch.no_grad():
                im_in = torch.clamp(x + noise.clamp(-eps_inf, eps_inf), 0.0, 1.0)
            return loss_i, im_in

        min_n, max_n, level = thr, f32(0.1), f32(0.1)
        loss_i_prev, loss_i = f32(0.0), f32(0.0)
        im_in, decisions = x, []
        while len(decisions) < cfg.search_steps:
            record: List[bool] = []
            loss_i, im_in = search_noise(level, record)
            converged = (abs(loss_i - loss_i_prev) < f32(cfg.noise_threshold * 0.01)
                         and abs(loss_i - thr) < f32(cfg.noise_threshold * 0.1))
            over = bool(loss_i > thr)
            decisions.append({"level": float(level), "reached": record, "over": over})
            max_n, min_n = (level, min_n) if over else (max_n, level)
            level = f32((min_n + max_n) / f32(2.0))
            loss_i_prev = loss_i
            if converged:
                break

        if not cfg.fast:
            with torch.no_grad():
                noise_f = im_in - x
                lo, hi = f32(0.0), f32(torch.max(torch.abs(noise_f)).item())
                while abs(lo - hi) > f32(1.0 / 256.0):
                    mid = f32((lo + hi) / f32(2.0))
                    capped = torch.mean(torch.clamp(noise_f, -float(mid), float(mid)) ** 2)
                    lo, hi = (lo, mid) if bool(capped > float(thr)) else (mid, hi)
                im_in = x + torch.clamp(noise_f, -float(hi), float(hi))

        ev = evaluate(model, im_in, x, output_s, clamp=cfg.clamp)
        ev.update({"output_s": output_s, "bpp_ori": bpp_ori,
                   "loss_i_final": torch.tensor(float(loss_i)),
                   "outer_rounds": len(decisions), "decisions": decisions})
        return ev

    return attack
