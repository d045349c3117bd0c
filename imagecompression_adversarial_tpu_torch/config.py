"""The CLI flags of the port's ``attack_rd``: the spellings of
``imagecompression_adversarial_tpu/config.py`` for the flags this slice
uses, with ``-device`` naming a torch device."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    device: str = "cuda"
    precision: str = "highest"  # 'highest'/'float32' turn TF32 off
    model: str = "hyper"
    metric: str = "ms-ssim"
    quality: int = 3
    new: bool = False
    padding_mode: str = "reflect"
    steps: int = 1001
    random: int = 1
    two_phase_impl: str = "cond"
    noise: float = 0.0001
    lr_attack: float = 0.01
    source: str = "./datasets/kodak/kodim*.png"
    target: Optional[str] = None
    checkpoint: Optional[str] = None
    att_metric: str = "L2"
    epsilon: float = 16.0
    pad: Optional[int] = None
    debug: bool = False
    clamp: bool = True
    phase_space: str = "auto"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RD attack on learned image codecs (PyTorch/CUDA)")
    d = Config()
    p.add_argument("-device", type=str, default=d.device,
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-precision", type=str, default=d.precision,
                   help="highest|float32 (no TF32) or default|tf32")
    p.add_argument("-m", dest="model", type=str, default=d.model,
                   help="factorized|hyper|context|cheng2020|cheng2020-attn|cheng2020-gmm|debug")
    p.add_argument("-metric", dest="metric", type=str, default=d.metric,
                   help="mse or ms-ssim (checkpoint flavour)")
    p.add_argument("-q", dest="quality", type=int, default=d.quality,
                   help="quality; 0 sweeps the family's qualities")
    p.add_argument("--new", dest="new", action="store_true", help="fresh params")
    p.add_argument("-padmode", dest="padding_mode", type=str, default=d.padding_mode)
    p.add_argument("-steps", dest="steps", type=int, default=d.steps)
    p.add_argument("-random", dest="random", type=int, default=d.random,
                   help="random restarts (only 1 is ported)")
    p.add_argument("-two_phase", dest="two_phase_impl", type=str,
                   default=d.two_phase_impl, choices=("cond", "select"),
                   help="two-phase loss: host if (cond) or torch.where (select)")
    p.add_argument("-noise", dest="noise", type=float, default=d.noise,
                   help="input L2 noise threshold")
    p.add_argument("-lr_attack", dest="lr_attack", type=float, default=d.lr_attack)
    p.add_argument("-s", dest="source", type=str, default=d.source)
    p.add_argument("-t", dest="target", type=str, default=d.target)
    p.add_argument("-ckpt", dest="checkpoint", type=str, default=d.checkpoint,
                   help="checkpoint: flax .msgpack or CompressAI .pth/.pth.tar")
    p.add_argument("-att_metric", dest="att_metric", type=str, default=d.att_metric,
                   help="L2 or ms-ssim")
    p.add_argument("-e", dest="epsilon", type=float, default=d.epsilon,
                   help="L-inf noise budget (/255)")
    p.add_argument("-p", dest="pad", type=int, default=d.pad)
    p.add_argument("--debug", dest="debug", action="store_true")
    p.add_argument("--no-clamp", dest="clamp", action="store_false")
    p.add_argument("-phase_space", dest="phase_space", type=str,
                   default=d.phase_space, choices=("auto", "on", "off"),
                   help="phase-space attack loss (auto: on when equivalent)")
    return p


def parse_config(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})


def apply_precision(cfg: Config) -> None:
    """'highest'/'float32' turn TF32 off for matmuls and cuDNN convs;
    'default'/'tf32' turn it on."""
    if cfg.precision not in ("highest", "float32", "default", "tf32"):
        raise ValueError(f"unknown precision {cfg.precision!r}")
    import torch

    tf32 = cfg.precision in ("default", "tf32")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
