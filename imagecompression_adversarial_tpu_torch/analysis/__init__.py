"""Corpus evaluations of a codec (port of the part of
``imagecompression_adversarial_tpu/analysis/`` that the evaluation CLIs
``random_noise`` and ``recompression`` run)."""

from .random_noise import calibrated_blur, gaussian_blur, make_deblur_eval_fn, make_noise_eval_fn
from .recompression import make_recompression_fn

__all__ = [
    "make_noise_eval_fn",
    "make_deblur_eval_fn",
    "calibrated_blur",
    "gaussian_blur",
    "make_recompression_fn",
]
