from .latent import (
    anomaly_score,
    clamp_feature_with_p,
    clamp_value_naive,
    clip_dead_channel,
    load_range_profile,
    make_latent_defend_fn,
    profile_path,
)
from .self_ensemble import (
    bitdepth_reduction,
    dihedral_forward,
    dihedral_inverse_group,
    draw_resize_scale,
    make_defend_fn,
    random_resize,
    self_ensemble,
)

__all__ = [
    "self_ensemble",
    "dihedral_forward",
    "dihedral_inverse_group",
    "bitdepth_reduction",
    "random_resize",
    "make_defend_fn",
    "clamp_value_naive",
    "clamp_feature_with_p",
    "clip_dead_channel",
    "make_latent_defend_fn",
    "draw_resize_scale",
    "anomaly_score",
    "load_range_profile",
    "profile_path",
]
