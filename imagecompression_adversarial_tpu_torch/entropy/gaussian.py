"""Conditional Gaussian entropy model (port of
``imagecompression_adversarial_tpu/entropy/gaussian.py``).

The likelihood of a quantized symbol v under N(mean, scale^2) is the CDF
difference over the unit bin, computed on the |v| fold with ``erfc`` so
both CDF evaluations sit on the safe tail.  Scales are clamped to
[0.11, 256] (the real coder's scale-table range) through the gated bounds,
so rate gradients keep flowing at the clamp.
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
):
    """Quantize ``y`` and return ``(y_hat, likelihoods)`` evaluated on the
    quantized values (``GaussianConditional.forward`` semantics)."""
    y_hat = quantize(y, quant_mode, means=means, generator=generator)
    lik = gaussian_likelihood(y_hat, scales, means=means)
    return y_hat, lower_bound(lik, _LIKELIHOOD_BOUND)
