from .codecs import (
    Cheng2020Anchor,
    Cheng2020Attention,
    Cheng2020AttnGMM,
    CodecModel,
    DebugCodec,
    FactorizedPrior,
    JointAutoregressive,
    ScaleHyperprior,
)
from .layers import GDN, Conv, Deconv, depth_to_space, space_to_depth
from .registry import ARCHITECTURES, init_model, model_dims, quality_range

__all__ = [
    "CodecModel",
    "FactorizedPrior",
    "ScaleHyperprior",
    "JointAutoregressive",
    "Cheng2020Anchor",
    "Cheng2020Attention",
    "Cheng2020AttnGMM",
    "DebugCodec",
    "GDN",
    "Conv",
    "Deconv",
    "depth_to_space",
    "space_to_depth",
    "ARCHITECTURES",
    "init_model",
    "model_dims",
    "quality_range",
]
