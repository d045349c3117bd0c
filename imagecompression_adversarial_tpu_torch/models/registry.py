"""Model factory: name + quality -> codec module (the rows of
``imagecompression_adversarial_tpu/models/registry.py``: all twelve
families)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..entropy.factorized import EntropyBottleneck
from .codecs import (
    Cheng2020Anchor,
    Cheng2020Attention,
    Cheng2020AttnGMM,
    CodecModel,
    DebugCodec,
    FactorizedPrior,
    JointAutoregressive,
    ScaleHyperprior,
)
from .fic import FIC
from .hific import HiFiC
from .invcompress import InvCompress, InvertibleConv1x1
from .layers import Conv, Deconv
from .nlaic import NLAIC
from .tic import TIC, Dense

ARCHITECTURES = (
    "factorized", "hyper", "context", "cheng2020", "cheng2020-attn", "debug",
    "cheng2020-gmm", "invcompress", "hific", "tic", "nlaic", "fic",
)
# the adapter families' widths at every quality: invcompress's latent is
# fixed at 768 (N is kept for symmetry), fic is Image_coding(3, 32, 192, 42, 64)
_FIXED_DIMS = {"debug": (3, 192), "invcompress": (192, 768), "hific": (220, 220),
               "tic": (128, 192), "fic": (192, 192)}
# modules whose parameters init_model draws from its seeded generator; the
# rest (norms, biases of attention) have constant inits
_SEEDED = (Conv, Deconv, EntropyBottleneck, Dense, InvertibleConv1x1)

# Quality -> (N, M), CompressAI zoo configuration.
_FACTORIZED_CFG = {q: (128, 192) if q <= 5 else (192, 320) for q in range(1, 9)}
_HYPER_CFG = dict(_FACTORIZED_CFG)
_CONTEXT_CFG = {q: (192, 192) if q <= 4 else (192, 320) for q in range(1, 9)}
_CHENG_CFG = {q: (128, 128) if q <= 3 else (192, 192) for q in range(1, 7)}

_CFG = {
    "factorized": _FACTORIZED_CFG,
    "hyper": _HYPER_CFG,
    "context": _CONTEXT_CFG,
    "cheng2020": _CHENG_CFG,
    "cheng2020-attn": _CHENG_CFG,
    "cheng2020-gmm": _CHENG_CFG,
    "nlaic": _CONTEXT_CFG,
}


def _check_family(model: str) -> None:
    if model not in ARCHITECTURES:
        raise ValueError(f"'{model}' not in {ARCHITECTURES} for param '-m'")


def quality_range(model: str) -> Tuple[int, int]:
    """Qualities of a family, first and last: the ``-q 0`` sweep."""
    _check_family(model)
    return (1, 6) if model.startswith("cheng2020") else (1, 8)


def model_dims(model: str, quality: int) -> Tuple[int, int]:
    """(N, M) of a family at a quality; debug and the adapter families but
    nlaic have one size."""
    _check_family(model)
    if model in _FIXED_DIMS:
        return _FIXED_DIMS[model]
    if quality not in _CFG[model]:
        raise ValueError(f"quality {quality} out of range for model {model!r}")
    return _CFG[model][quality]


def init_model(model: str, quality: int, seed: int = 0) -> CodecModel:
    """Build the codec with parameters drawn from a ``torch.Generator``
    seeded with ``seed`` (on the CPU; move it with ``.to``)."""
    n, m = model_dims(model, quality)
    module = {
        "factorized": lambda: FactorizedPrior(n, m),
        "hyper": lambda: ScaleHyperprior(n, m),
        "context": lambda: JointAutoregressive(n, m),
        "cheng2020": lambda: Cheng2020Anchor(n),
        "cheng2020-attn": lambda: Cheng2020Attention(n),
        "cheng2020-gmm": lambda: Cheng2020AttnGMM(n),
        "debug": lambda: DebugCodec(n, m),
        "invcompress": lambda: InvCompress(n, m),
        "hific": lambda: HiFiC(n, m),
        "tic": lambda: TIC(n, m),
        "nlaic": lambda: NLAIC(n, m),
        "fic": lambda: FIC(n, m),
    }[model]()
    generator = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, _SEEDED):
            sub.reset_parameters(generator)
    return module
