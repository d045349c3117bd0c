"""Bound operators with gradient-gated backward passes.

Port of ``imagecompression_adversarial_tpu/ops/bounds.py`` as
``torch.autograd.Function``s:

* ``lower_bound(x, b)``: forward ``max(x, b)``; the gradient passes where
  the input is inside the bound (``x >= b``) or where it points back inside
  (``g < 0``).
* ``upper_bound(x, b)``: forward ``min(x, b)``; passes where ``x <= b`` or
  ``g > 0``.
* ``ste_round(x)``: round (half to even) with identity gradient.
* ``universal_quant(x, generator)``: round with a shared uniform dither,
  identity gradient.

The gating lets the RD attack keep optimising a noise tensor that is
clipped every step: gradients that pull a saturated value back inside are
never masked.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return x.clamp(min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0.0)
        return g.masked_fill(~pass_through, 0.0), None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return x.clamp(max=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0.0)
        return g.masked_fill(~pass_through, 0.0), None


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _UniversalQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u):
        return torch.round(x + u) - u

    @staticmethod
    def backward(ctx, g):
        return g, None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound) with gradient-gated backward (see module docstring)."""
    return _LowerBound.apply(x, bound)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """min(x, bound) with gradient-gated backward (see module docstring)."""
    return _UpperBound.apply(x, bound)


def bound_clip(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Clip to [low, high] through the gated bounds."""
    return upper_bound(lower_bound(x, low), high)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) with identity gradient."""
    return _SteRound.apply(x)


def universal_quant(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Round with a shared uniform(-0.5, 0.5) dither drawn from
    ``generator``; identity gradient."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) - 0.5
    return _UniversalQuant.apply(x, u)
