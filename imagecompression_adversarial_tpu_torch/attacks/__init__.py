from .common import AdamOnNoise, RDAttackConfig, init_noise, multistep_lr_schedule
from .evaluate import evaluate
from .rd import make_attack_fn

__all__ = [
    "AdamOnNoise",
    "RDAttackConfig",
    "init_noise",
    "multistep_lr_schedule",
    "evaluate",
    "make_attack_fn",
]
