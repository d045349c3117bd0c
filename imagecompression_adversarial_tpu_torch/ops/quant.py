"""Latent quantization modes, passed explicitly (port of
``imagecompression_adversarial_tpu/ops/quant.py``).

The mode is an argument, not ``train()``/``eval()`` module state.
``torch.round``, like ``jnp.round``, rounds half to even.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import shard
from .bounds import ste_round, universal_quant

#: Valid quantization modes.
QUANT_MODES = ("noise", "dequantize", "ste", "none", "universal")


def uniform_noise(y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The training surrogate's uniform(-0.5, 0.5) noise of ``y``'s shape,
    drawn from ``generator`` (the one draw of ``'noise'`` mode; under a
    shard, ``y`` has the global shape, ``ops/shard.py::local_draw``)."""
    u = torch.rand(y.shape, generator=generator, device=y.device, dtype=y.dtype)
    return u - 0.5


def quantize(
    y: torch.Tensor,
    mode: str,
    means: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Quantize a latent tensor.

    Modes: ``'noise'`` adds uniform(-.5, .5) noise; ``'dequantize'`` is
    ``round(y - means) + means``; ``'ste'`` rounds with identity gradient;
    ``'none'`` passes through (the attack's quantization-free path);
    ``'universal'`` rounds with a shared dither and identity gradient.
    ``generator`` is required by ``'noise'`` and ``'universal'``.
    """
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
    if mode == "none":
        return y
    if mode in ("noise", "universal") and generator is None:
        raise ValueError(f"quantize(mode={mode!r}) requires a torch.Generator")
    if mode == "noise":
        return y + shard.local_draw(y, lambda full: uniform_noise(full, generator))
    centered = y if means is None else y - means
    if mode == "universal":
        rounded = universal_quant(centered, generator)
    elif mode == "ste":
        rounded = ste_round(centered)
    else:  # 'dequantize'
        rounded = torch.round(centered)
    return rounded if means is None else rounded + means
