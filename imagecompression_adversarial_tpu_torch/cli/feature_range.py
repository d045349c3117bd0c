"""CLI: profile the per-channel latent ranges over a corpus on the GPU
(port of ``imagecompression_adversarial_tpu/cli/feature_range.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.feature_range -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png'

Writes ``./attack/data/<model>-<metric>-<q>[-adv]_range.npz``, the profile
that the latent-clip defense and ``cli.search`` read (either package reads
the other's file).
"""

from __future__ import annotations

import numpy as np

from ..analysis import profile_latents, profile_path, save_profile
from ..config import apply_precision, parse_config
from ..io.image import list_images, read_image, to_tensor
from ..runtime import load_model


def run(cfg) -> str:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    print("[Activation Range Evaluator]:", cfg.source)
    files = list_images(cfg.source)
    if not files:
        raise SystemExit(f"no images match source glob {cfg.source!r}")
    images = (to_tensor(read_image(f)[0], device) for f in files[:10000])
    profile = profile_latents(model.g_a, images)
    path = profile_path(cfg.model, cfg.metric, cfg.quality, adv=cfg.adv)
    save_profile(profile, path)
    print(f"channel_max[:5]={np.round(profile['channel_max'][:5], 3)}")
    print(f"channel_min[:5]={np.round(profile['channel_min'][:5], 3)}")
    print(f"saved profile -> {path}")
    return path


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()
