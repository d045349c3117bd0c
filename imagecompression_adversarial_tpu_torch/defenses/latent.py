"""Latent-space defenses (port of
``imagecompression_adversarial_tpu/defenses/latent.py``): clamp the latent
to profiled per-channel ranges, to the predicted Gaussian, or by the
rank-order dead-channel rule, and re-enter the codec at ``from_latent``.

Profiles are ``.npz`` files with ``channel_max``/``channel_min`` (C,) and,
for the rank clip, ``dead`` and ``ranks_min`` (the JAX package's
``analysis/feature_range.py`` writes them).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch


def _per_channel(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v), dtype=like.dtype, device=like.device).reshape(1, -1, 1, 1)


def clamp_value_naive(y: torch.Tensor, channel_max, channel_min) -> torch.Tensor:
    """Clamp NCHW latents channelwise to the profiled [min, max] ranges."""
    return torch.clamp(y, _per_channel(channel_min, y), _per_channel(channel_max, y))


def clamp_feature_with_p(y: torch.Tensor, means: torch.Tensor, scales: torch.Tensor,
                         epsilon: float = 50.0) -> torch.Tensor:
    """Clamp the standardized prediction error to +-epsilon sigmas (scales
    floored at 0.11)."""
    scales = torch.clamp(scales, min=0.11)
    err = torch.clamp((y - means) / scales, -epsilon, epsilon)
    return err * scales + means


def clip_dead_channel(y: torch.Tensor, dead, ranks_min, tolerance: int = 100,
                      dead_bound: float = 1.5) -> torch.Tensor:
    """Rank-order latent defense on a ``(1, C, H, W)`` latent.

    Profiled-dead channels are clamped to ``[-dead_bound, dead_bound]``; a
    channel whose rank by spatial abs-max (descending, ties by channel
    index) is more than ``tolerance`` places above its profiled minimum
    rank is clamped to the abs-max of channel ``ranks_min[c]`` (the table
    indexed by the rank, as the reference does); the others pass.
    """
    if y.shape[0] != 1:
        raise ValueError("clip_dead_channel operates on a single image")
    c = y.shape[1]
    absmax = torch.amax(torch.abs(y), dim=(2, 3))[0]
    order = torch.argsort(-absmax, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(c, device=y.device)
    ranks_min = torch.as_tensor(np.asarray(ranks_min), dtype=torch.long, device=y.device)
    dead_mask = torch.as_tensor(np.asarray(dead), dtype=torch.bool, device=y.device)
    cap = absmax[ranks_min.clamp(0, c - 1)]
    misranked = rank < ranks_min - tolerance
    inf = torch.full_like(cap, float("inf"))
    hi = torch.where(dead_mask, torch.full_like(cap, dead_bound), torch.where(misranked, cap, inf))
    return torch.clamp(y, (-hi).reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1))


def make_latent_defend_fn(model, transform: Callable) -> Callable:
    """The evaluation's latent defense hook, ``x -> (x_hat, likelihoods)``:
    ``y = g_a(x)``, ``transform(y)``, then ``from_latent`` in ``dequantize``
    mode, so reconstruction and rate both come from the clamped latent."""

    def defend(x):
        result = model.from_latent(transform(model.g_a(x)), "dequantize")
        return result["x_hat"], result["likelihoods"]

    return defend


def profile_path(model: str, metric: str, quality: int, adv: bool = False,
                 root: str = "./attack/data") -> str:
    """Where the reference's profiler writes a model's latent profile."""
    name = f"{model}-{metric}-{quality}" + ("-adv" if adv else "")
    return os.path.join(root, f"{name}_range.npz")


def load_range_profile(path: str, require=()) -> Dict[str, np.ndarray]:
    """Load a latent profile; ``require`` names the keys the caller needs
    (``('dead', 'ranks_min')`` for the rank clip)."""
    data = np.load(path)
    out = {"channel_max": data["channel_max"], "channel_min": data["channel_min"]}
    for key in ("dead", "ranks_min", "ranks_max"):
        if key in data:
            out[key] = data[key]
    missing = [k for k in require if k not in out]
    if missing:
        raise ValueError(
            f"range profile {path!r} lacks {missing} (old range-only format?); "
            "re-profile the corpus with dead/rank statistics"
        )
    return out


def anomaly_score(y: torch.Tensor, channel_max, channel_min) -> torch.Tensor:
    """Out-of-range mass of a latent against a profile (>= 0; natural
    images score about 0)."""
    over = torch.clamp(y - _per_channel(channel_max, y), min=0.0)
    under = torch.clamp(_per_channel(channel_min, y) - y, min=0.0)
    return torch.sum(over + under) / y.numel()
