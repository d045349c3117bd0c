"""Latent activation-range profiling (port of
``imagecompression_adversarial_tpu/analysis/feature_range.py``): the
per-image channel max and min of ``g_a(x)`` over a corpus; a channel's
profile boundary is the k-th largest max (k = min(100, corpus size)) and
the k-th smallest min.  The profile feeds the latent clamp defenses
(``defenses/latent.py``) and the natural-adversarial search
(``analysis/search.py``).

A profile is an ``.npz`` with ``channel_max``, ``channel_min``, the
per-image stats, the rank statistics and the ``dead`` mask, under the JAX
package's keys, so either package reads the other's file.  Max, min and
abs-max come from one ``g_a`` call an image (abs-max is max(max, -min)).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from ..defenses.latent import profile_path

__all__ = ["profile_latents", "profile_path", "save_profile", "dead_channels"]


@torch.no_grad()
def profile_latents(g_a_fn: Callable[[torch.Tensor], torch.Tensor],
                    images: Iterable[torch.Tensor], k: int = 100) -> dict:
    """Profile the per-channel latent ranges of NCHW images."""
    maxs, mins = [], []
    for im in images:
        y = g_a_fn(im)
        maxs.append(torch.amax(y, dim=(0, 2, 3)).cpu().numpy())
        mins.append(torch.amin(y, dim=(0, 2, 3)).cpu().numpy())
    maxs = np.stack(maxs)  # (N, C)
    mins = np.stack(mins)
    absmaxs = np.maximum(maxs, -mins)

    kk = min(k, maxs.shape[0])
    channel_max = np.sort(maxs, axis=0)[-kk, :]
    channel_min = np.sort(mins, axis=0)[kk - 1, :]

    # each image ranks its channels by abs-max, descending; a channel keeps
    # its best and worst rank over the corpus (for clip_dead_channel)
    order = np.argsort(-absmaxs, axis=1)
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(order.shape[1])[None, :], axis=1)

    return {
        "channel_max": channel_max,
        "channel_min": channel_min,
        "per_image_max": maxs,
        "per_image_min": mins,
        "per_image_absmax": absmaxs,
        "ranks_max": ranks.max(axis=0),
        "ranks_min": ranks.min(axis=0),
        # activations that never leave [-2, 2] over the corpus
        "dead": (maxs.max(axis=0) < 2.0) & (mins.min(axis=0) > -2.0),
    }


def save_profile(profile: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **profile)


def dead_channels(profile: dict, threshold: float = 2.0) -> np.ndarray:
    """Channels whose activations never leave [-threshold, threshold]."""
    mx = profile["per_image_max"].max(axis=0)
    mn = profile["per_image_min"].min(axis=0)
    return np.where((mx < threshold) & (mn > -threshold))[0]
