"""CLI: GAN training of the HiFiC codec on the GPU (port of
``imagecompression_adversarial_tpu/cli/train_hific.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.train_hific -max_steps 30 \\
        [-data DIR] [-ckpt out.msgpack] [-device cpu]

Alternating generator and discriminator steps (``train/gan.py``) from
seeded weights, on batches of ``-batch_size`` 256x256 crops of ``-data``
(synthetic without it), one Adam at ``-lr_train`` each; a line every 10
steps.  ``-ckpt`` names the output, a flax msgpack of ``{"generator":
<codec tree>, "discriminator": <params>}`` (default
``./ckpts/hific/hific.msgpack``), which ``-m hific -ckpt`` reads back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..config import Config, apply_precision, build_parser
from ..io.image import to_tensor
from ..io.weights import codec_to_jax, flax_params, write_msgpack
from ..models import init_model
from ..models.hific import init_discriminator
from ..runtime import resolve_device
from ..train.data import make_batches, prefetch
from ..train.gan import make_gan_train_step

CROP = 256


def run(cfg: Config, data_root: Optional[str] = None, max_steps: Optional[int] = None) -> dict:
    """Train until ``max_steps`` (or the data ends), write the checkpoint
    and return the last step's logs as floats."""
    apply_precision(cfg)
    device = resolve_device(cfg.device)
    codec = init_model("hific", cfg.quality, seed=0).to(device, memory_format=torch.channels_last)
    disc = init_discriminator(codec.M, seed=1).to(device, memory_format=torch.channels_last)
    g_opt = torch.optim.Adam(codec.parameters(), lr=cfg.lr_train)
    d_opt = torch.optim.Adam(disc.parameters(), lr=cfg.lr_train)
    step_fn = make_gan_train_step(codec, disc, g_opt, d_opt)
    generator = torch.Generator(device).manual_seed(42)

    batches = prefetch(make_batches(data_root, cfg.batch_size, crop=CROP))
    t0 = time.time()
    logs = {}
    for step, batch_np in enumerate(batches):
        logs = step_fn(to_tensor(batch_np, device), generator)
        if step % 10 == 0:
            print(f"step {step} loss {float(logs['loss']):.4f} bpp {float(logs['bpp']):.4f} "
                  f"mse {float(logs['mse']):.5f} perc {float(logs['perceptual']):.4f} "
                  f"d {float(logs['d_loss']):.4f} t {time.time() - t0:.1f}s", flush=True)
        if max_steps is not None and step + 1 >= max_steps:
            break
    batches.close()

    out = cfg.checkpoint or "./ckpts/hific/hific.msgpack"
    write_msgpack(out, {"generator": codec_to_jax(codec, "hific"),
                        "discriminator": flax_params(disc)})
    print(f"saved -> {out}")
    return {k: float(v) for k, v in logs.items()}


def main(argv=None) -> dict:
    parser = build_parser()
    parser.add_argument("-data", dest="data_root", type=str, default=None)
    parser.add_argument("-max_steps", dest="max_steps", type=int, default=None)
    ns = parser.parse_args(argv)
    cfg = Config(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)})
    return run(cfg, data_root=ns.data_root, max_steps=ns.max_steps)


if __name__ == "__main__":
    main()
