"""Training of the codecs: RD loss, main and aux optimizers, data,
checkpoints, the training loop and the HiFiC GAN step (port of
``imagecompression_adversarial_tpu/train/``)."""

from .checkpoint import CheckpointManager, ckpt_dir_for
from .gan import (
    hific_generator_loss,
    make_gan_train_step,
    non_saturating_d_loss,
    non_saturating_g_loss,
)
from .loss import LAMBDA_MSE, LAMBDA_MSSSIM, lambda_for, rate_distortion_loss, recompression_loss
from .step import (
    ReduceLROnPlateau,
    TrainState,
    clip_by_global_norm_,
    create_train_state,
    parameter_groups,
    quantile_labels,
    train_step,
)

__all__ = [
    "rate_distortion_loss",
    "recompression_loss",
    "lambda_for",
    "LAMBDA_MSE",
    "LAMBDA_MSSSIM",
    "TrainState",
    "create_train_state",
    "train_step",
    "parameter_groups",
    "quantile_labels",
    "clip_by_global_norm_",
    "ReduceLROnPlateau",
    "CheckpointManager",
    "ckpt_dir_for",
    "non_saturating_g_loss",
    "non_saturating_d_loss",
    "hific_generator_loss",
    "make_gan_train_step",
]
