"""CLI: the canonical RD distortion attack over an image corpus, on the GPU.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_rd \
        -m hyper -q 1 -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack \
        -s 'kodim*.png' -steps 1001

Same flags, per-image line and ``AVG:`` line as
``imagecompression_adversarial_tpu/cli/attack_rd.py``; ``-device cpu`` runs
on the CPU.  Images are attacked one at a time.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..attacks import RDAttackConfig, make_attack_fn
from ..config import apply_precision, parse_config
from ..io.image import list_images, read_image, to_numpy, to_tensor, write_image
from ..runtime import load_model

Image = Tuple[str, np.ndarray, int, int]  # (name, (1, H, W, 3) array, h, w)


def _corpus(source: str) -> Iterable[Image]:
    files = list_images(source)
    if not files:
        raise SystemExit(f"no images match source glob {source!r}")
    for path in files:
        im, h, w = read_image(path)
        yield os.path.basename(path), im, h, w


def run(cfg, images: Optional[Iterable[Image]] = None) -> dict:
    """Attack every image of ``cfg.source`` (or of ``images``, given as
    ``(name, (1, H, W, 3) float32 array, h, w)``) and print the report."""
    if cfg.random > 1:
        raise NotImplementedError("random restarts (-random > 1) are not ported yet")
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    att_cfg = RDAttackConfig(
        steps=cfg.steps,
        lr=cfg.lr_attack,
        noise_threshold=cfg.noise,
        epsilon=cfg.epsilon,
        att_metric=cfg.att_metric,
        clamp=cfg.clamp,
        random_restarts=cfg.random,
        pad=cfg.pad,
        padding_mode=cfg.padding_mode,
        phase_space_loss={"auto": None, "on": True, "off": False}[cfg.phase_space],
        two_phase_impl=cfg.two_phase_impl,
    )
    attack = make_attack_fn(model, att_cfg)

    print("==================== ATTACK SETTINGS ====================")
    print(f"[ IMAGE ]: {cfg.source if images is None else '<in memory>'} -> {cfg.target}")
    print(f"Attack Loss Metric: {cfg.att_metric}")
    print(f"Noise Threshold (L2): {cfg.noise} (epsilon={cfg.epsilon})")
    print(f"{cfg.steps} Steps")
    print("=========================================================", flush=True)

    model_tag = f"{cfg.model}_{cfg.quality}_{cfg.metric}_"
    out_dir = "./attack/results/"
    sums = {"bpp_ori": 0.0, "bpp": 0.0, "vi": 0.0, "vi_msim": 0.0, "t": 0.0}
    n = 0
    for name, im, h, w in (_corpus(cfg.source) if images is None else images):
        x = to_tensor(im, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        res = attack(x)
        res = {k: (v.item() if v.dim() == 0 else to_numpy(v)) for k, v in res.items()}
        dt = time.time() - t0
        dbpp = (res["bpp"] - res["bpp_ori"]) / res["bpp_ori"]
        print(
            f"{name}: bpp_ori {res['bpp_ori']:.4f} bpp_adv {res['bpp']:.4f} "
            f"dbpp {dbpp:+.4f} vi {res['vi']:.4f} vi_msim {res['vi_msim']:.4f} "
            f"t {dt:.2f}s",
            flush=True,
        )
        if cfg.debug or cfg.target:
            os.makedirs(out_dir, exist_ok=True)
            stem = out_dir + model_tag + os.path.splitext(name)[0]
            write_image(res["im_"], f"{stem}_advin.png", h, w)
            write_image(res["output_"], f"{stem}_advout.png", h, w)
            write_image(np.clip(res["im_"] - im + 0.5, 0.0, 1.0), f"{stem}_noise.png", h, w)
        for k in ("bpp_ori", "bpp", "vi", "vi_msim"):
            sums[k] += float(res[k])
        sums["t"] += dt
        n += 1

    avg = {k: v / n for k, v in sums.items()}
    avg["dbpp"] = (avg["bpp"] - avg["bpp_ori"]) / avg["bpp_ori"]
    print(
        f"AVG: bpp_ori {avg['bpp_ori']:.4f} bpp_adv {avg['bpp']:.4f} "
        f"dbpp {avg['dbpp']:+.4f} vi {avg['vi']:.4f} vi_msim {avg['vi_msim']:.4f} "
        f"t {avg['t']:.2f}s",
        flush=True,
    )
    return avg


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.quality < 1:  # quality sweep over the hyper family
        for q in range(1, 9):
            cfg.quality = q
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
