"""CLI: the canonical RD distortion attack over an image corpus, on the GPU.

    python -m imagecompression_adversarial_tpu_torch.cli.attack_rd \
        -m hyper -q 1 -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack \
        -s 'kodim*.png' -steps 1001 [-random 2 [-restart_impl vmap]] [-attack_batch 2]
        [--split_eval]

Same flags, per-image line and ``AVG:`` line as
``imagecompression_adversarial_tpu/cli/attack_rd.py``; ``-device cpu`` runs
on the CPU.  Image ``i`` gets a ``torch.Generator`` seeded with ``i`` for
every noise init that draws (the debug fixture's, and the restarts': its R
restarts draw one after the other from it).  ``-random R`` keeps the best
of R restarts, run one after the other (``-restart_impl host``) or as one
batch (``vmap``); ``-attack_batch B`` (with ``-random 1``) attacks B images
of one shape as one batch.  ``-trace DIR`` attacks the last image once more
under ``torch.profiler`` and writes its chrome trace into DIR.
``--split_eval`` runs the large-image attack (``attacks/rd.py``: the loop
checkpointed by stage, then the evaluation one piece at a time), which
takes one image at a time: with ``-attack_batch`` above 1 it raises, and
its restarts run one after the other.  ``-m fic``
needs ``-random 2`` or more (its zero-noise start is a critical point), and
says so without it.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..attacks import RDAttackConfig, best_of_restarts, make_attack_fn, make_batch_attack_fn
from ..config import apply_precision, parse_config
from ..io.image import to_tensor, write_image
from ..models import quality_range
from ..runtime import load_model
from ._corpus import Image, corpus, sync, to_host


def run(cfg, images: Optional[Iterable[Image]] = None) -> dict:
    """Attack every image of ``cfg.source`` (or of ``images``, given as
    ``(name, (1, H, W, 3) float32 array, h, w)``) and print the report."""
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
        debug_model=(cfg.model == "debug"),
        pad=cfg.pad,
        padding_mode=cfg.padding_mode,
        phase_space_loss={"auto": None, "on": True, "off": False}[cfg.phase_space],
        split_eval=cfg.split_eval,
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

    def report(name, res, im, h, w, dt):
        nonlocal n
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

    items = corpus(cfg.source) if images is None else images
    last = None
    if cfg.attack_batch > 1 and cfg.random <= 1:
        batched = make_batch_attack_fn(model, att_cfg)
        groups = {}
        for item in items:
            groups.setdefault(item[1].shape, []).append(item)
        index = 0
        for group in groups.values():
            for i in range(0, len(group), cfg.attack_batch):
                chunk = group[i:i + cfg.attack_batch]
                xs = torch.cat([to_tensor(c[1], device) for c in chunk])
                gens = [torch.Generator(device).manual_seed(index + j) for j in range(len(chunk))]
                index += len(chunk)
                sync()
                t0 = time.time()
                res_b = batched(xs, gens)
                res_b = [to_host({k: v[j] for k, v in res_b.items()}) for j in range(len(chunk))]
                dt = (time.time() - t0) / len(chunk)
                for (name, im, h, w), res in zip(chunk, res_b):
                    report(name, res, im, h, w, dt)
                last = xs[-1:]
    else:
        for name, im, h, w in items:
            x = to_tensor(im, device)
            gen = torch.Generator(device).manual_seed(n)
            sync()
            t0 = time.time()
            if cfg.random > 1:
                res = best_of_restarts(attack, x, gen, cfg.random, impl=cfg.restart_impl)
            else:
                res = attack(x, gen)
            res = to_host(res)
            report(name, res, im, h, w, time.time() - t0)
            last = x

    if cfg.trace and last is not None:
        trace_attack(attack, last, cfg.trace)

    avg = {k: v / n for k, v in sums.items()}
    avg["dbpp"] = (avg["bpp"] - avg["bpp_ori"]) / avg["bpp_ori"]
    print(
        f"AVG: bpp_ori {avg['bpp_ori']:.4f} bpp_adv {avg['bpp']:.4f} "
        f"dbpp {avg['dbpp']:+.4f} vi {avg['vi']:.4f} vi_msim {avg['vi_msim']:.4f} "
        f"t {avg['t']:.2f}s",
        flush=True,
    )
    return avg


def trace_attack(attack, x: torch.Tensor, directory: str) -> str:
    """Attack ``x`` once more (single start, generator seeded 0) under
    ``torch.profiler``, every cuDNN plan already chosen, and write the
    chrome trace into ``directory``; returns its path."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if x.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        attack(x, torch.Generator(x.device).manual_seed(0))
        sync()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "attack_rd.json")
    prof.export_chrome_trace(path)
    print(f"[trace] torch.profiler trace written to {path}", flush=True)
    return path


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.model == "fic" and cfg.random <= 1:
        # fic decodes the un-quantized latent, so zero-init noise sits at an
        # exact critical point and never moves (models/fic.py)
        print("WARNING: -m fic with zero noise init cannot leave its critical "
              "point (vi stays 0); use -random 2 or more for uniform init", flush=True)
    if cfg.quality < 1:  # quality sweep over the family
        lo, hi = quality_range(cfg.model)
        for q in range(lo, hi + 1):
            cfg.quality = q
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
