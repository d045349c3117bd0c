"""Model factory: name + quality -> codec module (the hyper rows of
``imagecompression_adversarial_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..entropy.factorized import EntropyBottleneck
from .codecs import CodecModel, ScaleHyperprior
from .layers import Conv, Deconv

#: Families this port has so far.
ARCHITECTURES = ("hyper",)

# Quality -> (N, M), CompressAI zoo configuration.
_HYPER_CFG = {q: (128, 192) if q <= 5 else (192, 320) for q in range(1, 9)}


def model_dims(model: str, quality: int) -> Tuple[int, int]:
    if model != "hyper":
        raise ValueError(f"model {model!r} is not ported yet; have {ARCHITECTURES}")
    if quality not in _HYPER_CFG:
        raise ValueError(f"no quality {quality} for model {model!r}")
    return _HYPER_CFG[quality]


def init_model(model: str, quality: int, seed: int = 0) -> CodecModel:
    """Build the codec with parameters drawn from a ``torch.Generator``
    seeded with ``seed`` (on the CPU; move it with ``.to``)."""
    n, m = model_dims(model, quality)
    module = ScaleHyperprior(n, m)
    generator = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, (Conv, Deconv, EntropyBottleneck)):
            sub.reset_parameters(generator)
    return module
