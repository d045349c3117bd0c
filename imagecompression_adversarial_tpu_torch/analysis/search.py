"""Natural-adversarial-example search over a corpus (port of
``imagecompression_adversarial_tpu/analysis/search.py``): score each
image's latent against a profiled per-channel range; the images whose
channel extremes overshoot the profile by the largest normalized margin are
natural adversarial examples."""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch


def make_detect_fn(g_a_fn: Callable, channel_max, channel_min) -> Callable:
    """``x -> score`` of an NCHW image: the largest overshoot above
    ``channel_max`` over ``channel_max + 1`` plus the largest undershoot
    below ``channel_min`` over ``|channel_min + 1|``."""
    cmax_np = np.asarray(channel_max, np.float32).reshape(1, -1, 1, 1)
    cmin_np = np.asarray(channel_min, np.float32).reshape(1, -1, 1, 1)

    @torch.no_grad()
    def detect(x: torch.Tensor) -> torch.Tensor:
        y = g_a_fn(x)
        cmax, cmin = torch.from_numpy(cmax_np).to(y), torch.from_numpy(cmin_np).to(y)
        err_max = torch.clamp(torch.amax(y, dim=(2, 3), keepdim=True) - cmax, min=0.0)
        err_min = torch.clamp(torch.amin(y, dim=(2, 3), keepdim=True) - cmin, max=0.0)
        return torch.max(err_max / (cmax + 1.0)) + torch.max(torch.abs(err_min / (cmin + 1.0)))

    return detect


def search_corpus(detect_fn: Callable,
                  images: Iterable[Tuple[str, torch.Tensor]]) -> List[Tuple[str, float]]:
    """Score (name, NCHW image) pairs; the findings by descending score."""
    scores = [(name, float(detect_fn(im))) for name, im in images]
    return sorted(scores, key=lambda kv: -kv[1])
