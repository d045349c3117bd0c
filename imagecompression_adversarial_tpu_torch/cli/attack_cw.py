"""CLI: the Carlini & Wagner-style constrained attack (double bisection).

    python -m imagecompression_adversarial_tpu_torch.cli.attack_cw -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' -ssteps 20 [--fast]

Port of ``imagecompression_adversarial_tpu/cli/attack_cw.py``: ``-ssteps``
bisection rounds, ``-noise`` input budget, ``-la`` initial c; ``--fast``
runs the inner bisection to convergence.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from ..attacks.cw import CWAttackConfig, make_cw_attack_fn
from ..config import Config, apply_precision, build_parser
from ..io.image import to_tensor
from ..runtime import load_model
from ._corpus import Image, run_corpus


def run(cfg, fast: bool = False, images: Optional[Iterable[Image]] = None) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = CWAttackConfig(
        steps=cfg.steps,
        lr=cfg.lr_attack,
        noise_threshold=cfg.noise,
        epsilon=cfg.epsilon,
        lamb_attack=cfg.lamb_attack,
        search_steps=cfg.search_steps,
        clamp=cfg.clamp,
        fast=fast,
    )
    attack = make_cw_attack_fn(model, att_cfg)
    return run_corpus(cfg.source, lambda im, idx: attack(to_tensor(im, device)), images=images)


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--fast", action="store_true", help="run the inner bisection to convergence")
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    run(cfg, fast=ns.fast)


if __name__ == "__main__":
    main()
