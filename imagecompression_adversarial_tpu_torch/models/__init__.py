from .codecs import CodecModel, ScaleHyperprior
from .layers import GDN, Conv, Deconv, depth_to_space, space_to_depth
from .registry import ARCHITECTURES, init_model, model_dims

__all__ = [
    "CodecModel",
    "ScaleHyperprior",
    "GDN",
    "Conv",
    "Deconv",
    "depth_to_space",
    "space_to_depth",
    "ARCHITECTURES",
    "init_model",
    "model_dims",
]
