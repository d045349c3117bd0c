"""Corpus analyses of a codec (port of
``imagecompression_adversarial_tpu/analysis/``): latent range profiles,
the natural-adversarial search, random-noise and blur robustness,
recompression, noise transferability and the latent distribution."""

from .distribution import (
    channel_rates,
    latent_histogram,
    predicted_distribution,
    rate_inflation_ranking,
)
from .feature_range import dead_channels, profile_latents, profile_path, save_profile
from .random_noise import calibrated_blur, gaussian_blur, make_deblur_eval_fn, make_noise_eval_fn
from .recompression import make_recompression_fn
from .search import make_detect_fn, search_corpus
from .transfer import cross_image_matrix, cross_model_matrix, make_transfer_eval_fn, plot_matrix

__all__ = [
    "profile_latents",
    "profile_path",
    "save_profile",
    "dead_channels",
    "make_noise_eval_fn",
    "make_deblur_eval_fn",
    "calibrated_blur",
    "gaussian_blur",
    "make_recompression_fn",
    "make_detect_fn",
    "search_corpus",
    "make_transfer_eval_fn",
    "cross_image_matrix",
    "cross_model_matrix",
    "plot_matrix",
    "predicted_distribution",
    "channel_rates",
    "rate_inflation_ranking",
    "latent_histogram",
]
