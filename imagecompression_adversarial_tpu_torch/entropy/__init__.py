from .factorized import EntropyBottleneck
from .gaussian import gaussian_conditional, gaussian_likelihood

__all__ = ["EntropyBottleneck", "gaussian_conditional", "gaussian_likelihood"]
