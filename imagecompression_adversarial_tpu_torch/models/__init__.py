from .codecs import (
    Cheng2020Anchor,
    Cheng2020Attention,
    Cheng2020AttnGMM,
    CodecModel,
    DebugCodec,
    FactorizedPrior,
    JointAutoregressive,
    MeanScaleHyperprior,
    ScaleHyperprior,
)
from .fic import FIC
from .hific import HiFiC
from .invcompress import InvCompress
from .layers import GDN, Conv, Deconv, depth_to_space, space_to_depth
from .nlaic import NLAIC
from .registry import ARCHITECTURES, init_model, model_dims, quality_range
from .tic import TIC

__all__ = [
    "CodecModel",
    "FactorizedPrior",
    "ScaleHyperprior",
    "JointAutoregressive",
    "Cheng2020Anchor",
    "Cheng2020Attention",
    "Cheng2020AttnGMM",
    "DebugCodec",
    "MeanScaleHyperprior",
    "InvCompress",
    "HiFiC",
    "TIC",
    "NLAIC",
    "FIC",
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
