"""The CLI flags of the port's entry points: the spellings, destinations
and defaults of ``imagecompression_adversarial_tpu/config.py`` for the
flags the port uses, with ``-device`` naming a torch device."""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Config:
    device: str = "cuda"
    precision: str = "highest"  # 'highest'/'float32' turn TF32 off, the rest on
    trace: Optional[str] = None  # cli.train: torch.profiler trace of one step
    lr_train: float = 1e-4
    lamb: Optional[float] = None
    batch_size: int = 8
    model: str = "hyper"
    metric: str = "ms-ssim"
    quality: int = 3
    new: bool = False
    padding_mode: str = "reflect"
    steps: int = 1001
    random: int = 1
    restart_impl: str = "host"  # best-of-restarts: sequential or one batch
    two_phase_impl: str = "cond"
    lamb_attack: float = 0.2
    noise: float = 0.0001
    lr_attack: float = 0.01
    source: str = "./datasets/kodak/kodim*.png"
    target: Optional[str] = None
    checkpoint: Optional[str] = None
    mask_loc: Optional[List[int]] = None
    lamb_bkg_in: float = 1.0
    lamb_bkg_out: float = 1.0
    lamb_tar: float = 1.0
    att_metric: str = "L2"
    epsilon: float = 16.0
    pad: Optional[int] = None
    debug: bool = False
    clamp: bool = True
    search_steps: int = 20
    log: str = "./logs/log.txt"
    recompress: Optional[int] = None
    epochs: Optional[int] = None  # train: 200 (100 with --adv) unless set
    adv: bool = False  # train: adversarial finetuning; self_ensemble: adaptive attack
    defend: bool = False
    method: str = "ensemble"
    ensemble_impl: str = "scan"
    profile: Optional[str] = None  # latent range/rank profile (.npz) for clip
    degrade: Optional[str] = None  # random_noise: blurgen | deblur
    attack_batch: int = 1
    phase_space: str = "auto"
    split_eval: bool = False  # attack_rd: the large-image attack (attacks/rd.py)
    encode: bool = False
    decode: bool = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Learned image codecs: RD attacks, real bitstreams, training (PyTorch/CUDA)"
    )
    d = Config()
    p.add_argument("-device", type=str, default=d.device,
                   help="torch device: cuda (default) or cpu")
    p.add_argument("-precision", type=str, default=d.precision,
                   help="highest|float32: fp32 matmuls and convs (no TF32); "
                        "default|tf32|bfloat16: TF32 for cuBLAS and cuDNN, the card's "
                        "reduced-precision pass (JAX's bfloat16 and default are one bf16 "
                        "pass on a TPU; TF32 keeps 10 stored mantissa bits, bf16 7)")
    p.add_argument("-trace", dest="trace", type=str, default=d.trace,
                   help="directory for a torch.profiler chrome trace: cli.train of one "
                        "steady step, cli.attack_rd of the last image's attack run again")
    p.add_argument("-lr_train", dest="lr_train", type=float, default=d.lr_train)
    p.add_argument("-lamb", dest="lamb", type=float, default=d.lamb,
                   help="training lambda (default: per-quality table)")
    p.add_argument("-batch_size", type=int, default=d.batch_size)
    p.add_argument("-m", dest="model", type=str, default=d.model,
                   help="factorized|hyper|context|cheng2020|cheng2020-attn|cheng2020-gmm|"
                        "debug|invcompress|hific|tic|nlaic|fic")
    p.add_argument("-metric", dest="metric", type=str, default=d.metric,
                   help="mse or ms-ssim (checkpoint flavour)")
    p.add_argument("-q", dest="quality", type=int, default=d.quality,
                   help="quality; 0 sweeps the family's qualities")
    p.add_argument("--new", dest="new", action="store_true", help="fresh params")
    p.add_argument("-padmode", dest="padding_mode", type=str, default=d.padding_mode)
    p.add_argument("-steps", dest="steps", type=int, default=d.steps)
    p.add_argument("--adv", action="store_true",
                   help="cli.train: adversarial finetuning; self_ensemble: adaptive "
                        "attack through the defense")
    p.add_argument("-random", dest="random", type=int, default=d.random,
                   help="random restarts (best-of)")
    p.add_argument("-restart_impl", dest="restart_impl", type=str,
                   default=d.restart_impl, choices=("vmap", "host"),
                   help="best-of-restarts: sequential attacks (host) or one "
                        "batched attack over the restarts' noises (vmap)")
    p.add_argument("-la", dest="lamb_attack", type=float, default=d.lamb_attack)
    p.add_argument("-two_phase", dest="two_phase_impl", type=str,
                   default=d.two_phase_impl, choices=("cond", "select"),
                   help="two-phase loss: host if (cond) or torch.where (select)")
    p.add_argument("-noise", dest="noise", type=float, default=d.noise,
                   help="input L2 noise threshold")
    p.add_argument("-lr_attack", dest="lr_attack", type=float, default=d.lr_attack)
    p.add_argument("-s", dest="source", type=str, default=d.source)
    p.add_argument("-t", dest="target", type=str, default=d.target)
    p.add_argument("-ckpt", dest="checkpoint", type=str, default=d.checkpoint,
                   help="checkpoint: flax .msgpack, CompressAI .pth/.pth.tar, or this "
                        "port's cli.train output (checkpoint.pt, or its step or best_loss "
                        "directory)")
    p.add_argument("--mask_loc", nargs="+", type=int, default=d.mask_loc,
                   help="targeted ROI box x0 x1 y0 y1")
    p.add_argument("-la_bkg_in", dest="lamb_bkg_in", type=float, default=d.lamb_bkg_in)
    p.add_argument("-la_bkg_out", dest="lamb_bkg_out", type=float, default=d.lamb_bkg_out)
    p.add_argument("-la_tar", dest="lamb_tar", type=float, default=d.lamb_tar)
    p.add_argument("-att_metric", dest="att_metric", type=str, default=d.att_metric,
                   help="L2 or ms-ssim")
    p.add_argument("-e", dest="epsilon", type=float, default=d.epsilon,
                   help="L-inf noise budget (/255)")
    p.add_argument("-p", dest="pad", type=int, default=d.pad)
    p.add_argument("--debug", dest="debug", action="store_true")
    p.add_argument("--no-clamp", dest="clamp", action="store_false")
    p.add_argument("-log", "--log", dest="log", type=str, default=d.log,
                   help="cli.train: JSONL training curve, a line an eval")
    p.add_argument("-re", dest="recompress", type=int, default=d.recompress,
                   help="cli.train: recompression-regularized training; cli.recompression: "
                        "the number of cycles (default: -steps)")
    p.add_argument("-epochs", dest="epochs", type=int, default=d.epochs,
                   help="training epochs (default 200, 100 with --adv)")
    p.add_argument("-ssteps", dest="search_steps", type=int, default=d.search_steps,
                   help="CW bisection rounds")
    p.add_argument("--defend", action="store_true")
    p.add_argument("--defend_m", dest="method", type=str, default=d.method,
                   help="ensemble|resize|bitdepth|clip")
    p.add_argument("-ensemble_impl", dest="ensemble_impl", type=str,
                   default=d.ensemble_impl, choices=["scan", "batch"],
                   help="adaptive in-loop ensemble: one checkpointed variant "
                        "at a time (scan) or two batches of 4")
    p.add_argument("-profile", dest="profile", type=str, default=d.profile,
                   help="latent range/rank profile .npz (for --defend_m clip; "
                        "defaults to the feature_range naming scheme)")
    p.add_argument("-degrade", dest="degrade", type=str, default=d.degrade,
                   help="cli.random_noise: blurgen (blur -s to the -noise MSE) or deblur "
                        "(-s blurred against -t sharp)")
    p.add_argument("-attack_batch", dest="attack_batch", type=int,
                   default=d.attack_batch, help="images attacked in one batch")
    p.add_argument("-phase_space", dest="phase_space", type=str,
                   default=d.phase_space, choices=("auto", "on", "off"),
                   help="phase-space attack loss (auto: on when equivalent)")
    p.add_argument("--split_eval", dest="split_eval", action="store_true",
                   help="attack scan and eval as separate stages "
                        "(megapixel single-card attacks)")
    p.add_argument("--encode", action="store_true",
                   help="cli.codec: encode the -s glob to .bin bitstreams under -t")
    p.add_argument("--decode", action="store_true",
                   help="cli.codec: decode a -s glob of .bin bitstreams to PNGs under -t")
    # flags the JAX parser accepts and no JAX entry point reads (--eval, -r,
    # --fintune) or that configure XLA (-compile_cache): accepted and
    # ignored, so a JAX command line runs unchanged
    ignored = "accepted and ignored (a flag of the JAX CLI)"
    p.add_argument("--eval", dest="_eval", action="store_true", help=ignored)
    p.add_argument("-r", dest="_rate", action="store_true", help=ignored)
    p.add_argument("--fintune", dest="_finetune", action="store_true", help=ignored)
    p.add_argument("-compile_cache", dest="_compile_cache", type=str, default=None, help=ignored)
    return p


def parse_config(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})


#: -precision values: whether each turns TF32 on.  JAX maps 'bfloat16' and
#: 'default' to one bf16 pass on the TPU's MXU, its reduced precision; the
#: card's counterpart is TF32, so both select it, as 'tf32' does.
PRECISIONS = {"highest": False, "float32": False, "default": True, "tf32": True,
              "bfloat16": True}


def apply_precision(cfg: Config) -> None:
    """'highest'/'float32' turn TF32 off for matmuls and cuDNN convs;
    'default', 'tf32' and 'bfloat16' turn it on."""
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"unknown precision {cfg.precision!r}")
    import torch

    tf32 = PRECISIONS[cfg.precision]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
