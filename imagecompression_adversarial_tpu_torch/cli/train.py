"""CLI: RD training, adversarial finetuning and recompression training on
the GPU (port of ``imagecompression_adversarial_tpu/cli/train.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.train -m hyper -q 1 \
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -max_steps 50
    # adversarial finetuning: a 101-step RD attack on each batch first
    python -m imagecompression_adversarial_tpu_torch.cli.train -m hyper -q 1 \
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack \
        --adv -noise 0.0001 -steps 101 -max_steps 12

Checkpoints go to ``./ckpts/{anchor|adv|recompress}/...`` under the
working directory, and a rerun there resumes from the latest, also from
the JAX trainer's orbax steps (``-m hyper -q 4 -metric mse --adv -steps
300`` resumes ``ckpts/adv/hyper-0.013-mse-0.0001-300/2000``; it needs
libzstd).  ``-data``
(or the directory of ``-s``) names the training images; without one the
batches are synthetic.  ``-device cpu`` runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

from ..config import Config, apply_precision, build_parser


def main(argv=None) -> dict:
    parser = build_parser()
    parser.add_argument("-data", dest="data_root", type=str, default=None,
                        help="training image folder (default: -s dir or synthetic)")
    parser.add_argument("-max_steps", dest="max_steps", type=int, default=None,
                        help="stop after N steps (smoke runs)")
    parser.add_argument("-augment", dest="augment", action="store_true",
                        help="random dihedral augmentation (flips + rot90)")
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    apply_precision(cfg)

    data_root = ns.data_root
    if data_root is None and cfg.source and os.path.isdir(os.path.dirname(cfg.source)):
        data_root = os.path.dirname(cfg.source)

    from ..train.trainer import train

    summary = train(cfg, data_root=data_root, max_steps=ns.max_steps, augment=ns.augment)
    print("TRAIN DONE:", {k: v for k, v in summary.items() if k != "state"})
    return summary


if __name__ == "__main__":
    main()
