from .factorized import EntropyBottleneck
from .gaussian import (
    gaussian_conditional,
    gaussian_likelihood,
    gaussian_mixture_conditional,
    gaussian_mixture_likelihood,
)

__all__ = [
    "EntropyBottleneck",
    "gaussian_conditional",
    "gaussian_likelihood",
    "gaussian_mixture_conditional",
    "gaussian_mixture_likelihood",
]
