"""CLI: latent-linearity analysis on the GPU (port of
``imagecompression_adversarial_tpu/cli/attack_linear.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.attack_linear -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' -steps 1001

Runs the RD attack on the first 4 images of ``-s``, then compares the
natural and the adversarial latent's channel maxima with the profiled
ranges of ``cli.feature_range``: a line an image with vi and the channels
over the profile.  The maxima go to ``<model>_<q>_<stem>_activations.npz``
and their bar chart to ``..._activations.png`` (where matplotlib is
installed).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..analysis import profile_path
from ..attacks import RDAttackConfig, make_attack_fn
from ..config import apply_precision, parse_config
from ..io.image import list_images, read_image, to_tensor
from ..runtime import load_model
from ..utils import channel_maxima, plot_or_skip, show_max_bar


def run(cfg) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    attack = make_attack_fn(model, RDAttackConfig(
        steps=cfg.steps, lr=cfg.lr_attack, noise_threshold=cfg.noise, epsilon=cfg.epsilon,
        clamp=cfg.clamp))
    files = list_images(cfg.source)
    if not files:
        raise SystemExit(f"no images match source glob {cfg.source!r}")

    prof_file = profile_path(cfg.model, cfg.metric, cfg.quality, adv=cfg.adv)
    profile = None
    if os.path.exists(prof_file):
        data = np.load(prof_file)
        profile = {"channel_max": data["channel_max"], "channel_min": data["channel_min"]}

    out = {}
    for path in files[:4]:
        x = to_tensor(read_image(path)[0], device)
        res = attack(x)
        with torch.no_grad():
            y_nat, y_adv = model.g_a(x), model.g_a(res["im_"])
        stem = os.path.splitext(os.path.basename(path))[0]
        save = f"{cfg.model}_{cfg.quality}_{stem}_activations.png"
        adv_max = channel_maxima(y_adv)
        np.savez(os.path.splitext(save)[0] + ".npz", natural=channel_maxima(y_nat),
                 adversarial=adv_max)
        plot_or_skip(show_max_bar, save, [y_nat, y_adv],
                     ["natural example", "adversarial example"], save_path=save, sort=True)
        vi = float(res["vi"])
        exceeded = None
        if profile is not None:
            exceeded = int(np.sum(adv_max > profile["channel_max"]))
            print(f"{stem}: vi {vi:.4f} channels over profiled range: "
                  f"{exceeded}/{adv_max.shape[0]} plot -> {save}")
        else:
            print(f"{stem}: vi {vi:.4f} plot -> {save} "
                  f"(no range profile at {prof_file}; run cli.feature_range)")
        out[stem] = {"vi": vi, "exceeded": exceeded}
    return out


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()
