from .bounds import bound_clip, lower_bound, ste_round, universal_quant, upper_bound
from .quant import QUANT_MODES, quantize

__all__ = [
    "bound_clip",
    "lower_bound",
    "upper_bound",
    "ste_round",
    "universal_quant",
    "QUANT_MODES",
    "quantize",
]
