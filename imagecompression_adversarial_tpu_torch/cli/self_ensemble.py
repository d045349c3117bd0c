"""CLI: defense evaluation: attack each image, evaluate through the defense.

    python -m imagecompression_adversarial_tpu_torch.cli.self_ensemble -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' \\
        --defend --defend_m ensemble [--adv [-ensemble_impl scan|batch]]

Port of ``imagecompression_adversarial_tpu/cli/self_ensemble.py``, same
flags and report lines.  The RD attack runs on each image and its final
evaluation goes through the defense (``--defend_m ensemble|resize|
bitdepth|clip``; ``clip`` reads the latent profile ``-profile``); ``--adv``
makes the attack adaptive: its loss goes through the defense too.
``-q 0`` sweeps the family's qualities.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional

from ..attacks import RDAttackConfig, make_attack_fn
from ..config import apply_precision, parse_config
from ..defenses import (
    clip_dead_channel,
    load_range_profile,
    make_defend_fn,
    make_latent_defend_fn,
    profile_path,
)
from ..io.image import to_tensor
from ..models import quality_range
from ..runtime import load_model
from ._corpus import Image, run_corpus


def run(cfg, images: Optional[Iterable[Image]] = None) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = RDAttackConfig(
        steps=cfg.steps,
        lr=cfg.lr_attack,
        noise_threshold=cfg.noise,
        epsilon=cfg.epsilon,
        clamp=cfg.clamp,
        defend_in_loop=cfg.method if (cfg.adv and cfg.defend) else None,
        ensemble_impl=cfg.ensemble_impl,
    )
    latent_transform = None
    if cfg.defend and cfg.method == "clip":
        prof_file = cfg.profile or profile_path(cfg.model, cfg.metric, cfg.quality)
        prof = load_range_profile(prof_file, require=("dead", "ranks_min"))
        transform = partial(clip_dead_channel, dead=prof["dead"], ranks_min=prof["ranks_min"])
        defend_builder = lambda m: make_latent_defend_fn(m, transform)  # noqa: E731
        if att_cfg.defend_in_loop == "clip":
            latent_transform = transform
    elif cfg.defend:
        defend_builder = lambda m: make_defend_fn(m, cfg.method)  # noqa: E731
    else:
        defend_builder = None
    attack = make_attack_fn(model, att_cfg, defend_fn_builder=defend_builder,
                            latent_transform=latent_transform)
    return run_corpus(cfg.source, lambda im, idx: attack(to_tensor(im, device)), images=images)


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.quality < 1:  # quality sweep over the family
        lo, hi = quality_range(cfg.model)
        for q in range(lo, hi + 1):
            cfg.quality = q
            print(f"== quality {q} ==")
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
