"""CLI: adversarial dataset generator.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_data -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'div2k/*.png' -out adv/

Port of ``imagecompression_adversarial_tpu/cli/attack_data.py``: attacks
each image of the corpus with the untargeted (or ROI, ``--mask_loc``)
attack of ``attacks/targeted.py`` and writes the adversarial copy, under
its own name, into ``-out``.  ``-att_metric L1|L2|masked`` picks the loss.
"""

from __future__ import annotations

import dataclasses
import os
import time

from ..attacks.targeted import TargetedAttackConfig, make_targeted_attack_fn
from ..config import Config, apply_precision, build_parser
from ..io.image import to_numpy, to_tensor, write_image
from ..runtime import load_model
from ._corpus import corpus, sync


def run(cfg, out_dir: str) -> int:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = TargetedAttackConfig(
        steps=cfg.steps,
        lr=cfg.lr_attack,
        noise_threshold=cfg.noise,
        att_metric=cfg.att_metric if cfg.att_metric in ("L1", "L2", "masked") else "L2",
        clamp=cfg.clamp,
        mask_loc=tuple(cfg.mask_loc) if cfg.mask_loc else None,
    )
    attack = make_targeted_attack_fn(model, att_cfg)
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name, im, h, w in corpus(cfg.source):
        sync()
        t0 = time.time()
        res = attack(to_tensor(im, device))
        write_image(to_numpy(res["im_"]), os.path.join(out_dir, name), h, w)
        print(f"{name}: vi {float(res['vi']):.4f} t {time.time() - t0:.2f}s", flush=True)
        n += 1
    print(f"wrote {n} adversarial images -> {out_dir}")
    return n


def main(argv=None):
    parser = build_parser()
    parser.add_argument("-out", dest="out_dir", type=str, default="./datasets/attack/adv",
                        help="output dataset dir")
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    run(cfg, ns.out_dir)


if __name__ == "__main__":
    main()
