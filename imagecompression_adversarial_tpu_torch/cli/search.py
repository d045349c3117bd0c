"""CLI: natural-adversarial-example search over a corpus on the GPU (port
of ``imagecompression_adversarial_tpu/cli/search.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.search -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png'

Scores every image's latent against the range profile of
``cli.feature_range`` and prints each new best (``FOUND YOU!``), writing
it and its reconstruction into ``./attack/search/``; ``-q 0`` sweeps the
family's qualities.
"""

from __future__ import annotations

import os

import torch

from ..analysis import make_detect_fn, profile_path
from ..config import apply_precision, parse_config
from ..defenses import load_range_profile
from ..io.image import list_images, read_image, to_numpy, to_tensor, write_image
from ..models import quality_range
from ..runtime import load_model


def run(cfg) -> list:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    path = profile_path(cfg.model, cfg.metric, cfg.quality, adv=cfg.adv)
    if not os.path.exists(path):
        raise SystemExit(f"no range profile at {path}; run cli.feature_range first")
    profile = load_range_profile(path)
    detect = make_detect_fn(model.g_a, profile["channel_max"], profile["channel_min"])
    files = list_images(cfg.source)
    if not files:
        raise SystemExit(f"no images match source glob {cfg.source!r}")

    save_path = "./attack/search/"
    score_best = 0.0
    findings = []
    for f in files:
        im, h, w = read_image(f)
        x = to_tensor(im, device)
        score = float(detect(x))
        findings.append((f, score))
        if score > score_best:
            print("FOUND YOU!", f, score)
            score_best = score
            os.makedirs(save_path, exist_ok=True)
            with torch.no_grad():
                x_hat = model(x, quant_mode="dequantize")["x_hat"].clamp(0.0, 1.0)
            stem = os.path.splitext(os.path.basename(f))[0]
            write_image(im, save_path + stem + ".png", h, w)
            write_image(to_numpy(x_hat), save_path + stem + f"_{score:.4f}.png", h, w)
    return sorted(findings, key=lambda kv: -kv[1])


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.quality < 1:  # the quality sweep
        lo, hi = quality_range(cfg.model)
        for q in range(lo, hi + 1):
            cfg.quality = q
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
