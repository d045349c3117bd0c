"""Latent-distribution analysis (port of
``imagecompression_adversarial_tpu/analysis/distribution.py``): the
predicted symbol distribution of the conditional Gaussian on the integer
lattice, each channel's rate, the ranking of channels by rate inflation
between a natural and an adversarial input, and histogram data.  Tensors
are NCHW."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..entropy.gaussian import gaussian_likelihood


@torch.no_grad()
def predicted_distribution(means: torch.Tensor, scales: torch.Tensor,
                           grid: Tuple[int, int] = (-30, 30)) -> torch.Tensor:
    """P(v) for each integer v of ``grid`` (inclusive) and each (mean,
    scale) element, by CDF differences: ``(grid size, *means.shape)``."""
    lo, hi = grid
    vs = torch.arange(lo, hi + 1, dtype=means.dtype, device=means.device)
    vs = vs.reshape(-1, *([1] * means.dim())).expand(-1, *means.shape)
    return gaussian_likelihood(vs, scales.expand_as(vs), means.expand_as(vs))


def channel_rates(likelihoods: torch.Tensor) -> torch.Tensor:
    """Per-channel bits of an NCHW likelihood tensor."""
    return torch.sum(-torch.log2(likelihoods), dim=(0, 2, 3))


def rate_inflation_ranking(lik_natural: torch.Tensor,
                           lik_adversarial: torch.Tensor) -> Dict[str, np.ndarray]:
    """Channels ranked by their rate increase, adversarial against natural."""
    r_nat = channel_rates(lik_natural).cpu().numpy()
    r_adv = channel_rates(lik_adversarial).cpu().numpy()
    inflation = r_adv - r_nat
    return {
        "rate_natural": r_nat,
        "rate_adversarial": r_adv,
        "inflation": inflation,
        "ranking": np.argsort(-inflation),
    }


def latent_histogram(y_hat: torch.Tensor, channel: int, bins: int = 61,
                     value_range=(-30.0, 30.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Empirical density histogram of one channel of an NCHW latent."""
    vals = y_hat[:, channel].detach().cpu().numpy().ravel()
    return np.histogram(vals, bins=bins, range=value_range, density=True)
