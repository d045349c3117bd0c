"""Conditional Gaussian entropy model (port of
``imagecompression_adversarial_tpu/entropy/gaussian.py``).

The likelihood of a quantized symbol v under N(mean, scale^2) is the CDF
difference over the unit bin, computed on the |v| fold with ``erfc`` so
both CDF evaluations sit on the safe tail.  Scales are clamped to
[0.11, 256] (the real coder's scale-table range) through the gated bounds,
so rate gradients keep flowing at the clamp.  The K-component mixture of
cheng2020-gmm bounds its scales below only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.bounds import lower_bound, upper_bound
from ..ops.quant import quantize

_LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11
SCALES_MAX = 256.0


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) via erfc (tail-accurate)."""
    return 0.5 * torch.special.erfc(-(2.0 ** -0.5) * x)


def gaussian_likelihood(
    values: torch.Tensor,
    scales: torch.Tensor,
    means: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Unit-bin likelihood of (already quantized) ``values``."""
    if means is not None:
        values = values - means
    scales = upper_bound(lower_bound(scales, SCALE_BOUND), SCALES_MAX)
    values = torch.abs(values)
    upper = _standardized_cumulative((0.5 - values) / scales)
    lower = _standardized_cumulative((-0.5 - values) / scales)
    return upper - lower


def gaussian_conditional(
    y: torch.Tensor,
    scales: torch.Tensor,
    means: Optional[torch.Tensor] = None,
    quant_mode: str = "noise",
    generator: Optional[torch.Generator] = None,
    means_free_round: bool = False,
):
    """Quantize ``y`` and return ``(y_hat, likelihoods)`` evaluated on the
    quantized values (``GaussianConditional.forward`` semantics).

    ``means_free_round=True`` rounds ``y`` without the mean offset and still
    evaluates N(mean, scale^2) at the rounded point: the convention of a
    coder that writes plain ``round(y)`` symbols and keeps the fractional
    mean in the CDF row (fic's ``context4``)."""
    y_hat = quantize(y, quant_mode, means=None if means_free_round else means,
                     generator=generator)
    lik = gaussian_likelihood(y_hat, scales, means=means)
    return y_hat, lower_bound(lik, _LIKELIHOOD_BOUND)


def gaussian_mixture_likelihood(
    values: torch.Tensor,
    scales: torch.Tensor,
    means: torch.Tensor,
    weight_logits: torch.Tensor,
) -> torch.Tensor:
    """Unit-bin likelihood of ``values`` (...) under a K-component Gaussian
    mixture whose ``scales``/``means``/``weight_logits`` carry a trailing
    component axis (..., K); the weights are the softmax of the logits."""
    scales = lower_bound(scales, SCALE_BOUND)
    centered = torch.abs(values.unsqueeze(-1) - means)
    upper = _standardized_cumulative((0.5 - centered) / scales)
    lower = _standardized_cumulative((-0.5 - centered) / scales)
    weights = torch.softmax(weight_logits, dim=-1)
    return torch.sum(weights * (upper - lower), dim=-1)


def gaussian_mixture_conditional(
    y: torch.Tensor,
    scales: torch.Tensor,
    means: torch.Tensor,
    weight_logits: torch.Tensor,
    quant_mode: str = "noise",
    generator: Optional[torch.Generator] = None,
):
    """Quantize ``y`` means-free (as the autoregressive families do) and
    return ``(y_hat, likelihoods)`` of the mixture on the quantized values."""
    y_hat = quantize(y, quant_mode, means=None, generator=generator)
    lik = gaussian_mixture_likelihood(y_hat, scales, means, weight_logits)
    return y_hat, lower_bound(lik, _LIKELIHOOD_BOUND)
