from .common import AdamOnNoise, RDAttackConfig, init_noise, multistep_lr_schedule
from .cw import CWAttackConfig, make_cw_attack_fn
from .evaluate import evaluate
from .ifgsm import IFGSMConfig, best_of_multistart, make_ifgsm_fn
from .patch import extract_worst_patch, local_vi_map
from .rd import best_of_restarts, make_adv_example_fn, make_attack_fn, make_batch_attack_fn
from .targeted import TargetedAttackConfig, make_targeted_attack_fn, roi_masks

__all__ = [
    "AdamOnNoise",
    "RDAttackConfig",
    "init_noise",
    "multistep_lr_schedule",
    "evaluate",
    "make_attack_fn",
    "make_batch_attack_fn",
    "make_adv_example_fn",
    "best_of_restarts",
    "IFGSMConfig",
    "make_ifgsm_fn",
    "best_of_multistart",
    "CWAttackConfig",
    "make_cw_attack_fn",
    "TargetedAttackConfig",
    "make_targeted_attack_fn",
    "roi_masks",
    "extract_worst_patch",
    "local_vi_map",
]
