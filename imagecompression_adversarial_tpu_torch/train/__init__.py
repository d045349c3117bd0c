"""Training of the codecs: RD loss, main and aux optimizers, data,
checkpoints and the training loop (port of
``imagecompression_adversarial_tpu/train/``, without ``gan.py``)."""

from .checkpoint import CheckpointManager, ckpt_dir_for
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
]
