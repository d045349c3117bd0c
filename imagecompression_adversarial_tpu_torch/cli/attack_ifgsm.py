"""CLI: the sign-gradient attack (MI-FGSM), best of ``-random N`` PGD starts.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_ifgsm -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' -steps 101 -random 2

Port of ``imagecompression_adversarial_tpu/cli/attack_ifgsm.py``: momentum
on, as the reference's entry point; ``-random N`` (N > 1) starts N PGD
runs one after the other from a ``torch.Generator`` seeded with the image's
index and keeps the best vi.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..attacks.ifgsm import IFGSMConfig, best_of_multistart, make_ifgsm_fn
from ..config import apply_precision, parse_config
from ..io.image import to_tensor
from ..runtime import load_model
from ._corpus import Image, run_corpus


def run(cfg, images: Optional[Iterable[Image]] = None) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = IFGSMConfig(steps=cfg.steps, epsilon=cfg.epsilon, random_start=cfg.random > 1,
                          momentum=True, clamp=cfg.clamp)
    attack = make_ifgsm_fn(model, att_cfg)

    def per_image(im, idx):
        x = to_tensor(im, device)
        gen = torch.Generator(device).manual_seed(idx)
        if cfg.random > 1:
            return best_of_multistart(attack, x, gen, cfg.random)
        return attack(x, gen)

    return run_corpus(cfg.source, per_image, images=images)


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()
