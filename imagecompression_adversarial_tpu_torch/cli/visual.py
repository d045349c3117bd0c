"""CLI: encode/decode visualization dumps on the GPU (port of
``imagecompression_adversarial_tpu/cli/visual.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.visual -m hyper -q 1 \\
        -metric mse -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s in.png -t out.png \\
        [-degrade noise]

Writes the reconstruction (``-t``, default ``rec.png``) and the quantized
latent as ``<out>_y_hat.npy`` (NHWC, as the JAX CLI writes it) and prints
the PSNR.  ``-degrade noise`` first adds Gaussian noise of sigma 0.0316,
drawn from a ``torch.Generator`` seeded 0 on the CPU (other noise than the
JAX CLI's ``PRNGKey(0)``), and writes the noised input as ``<out>_in.png``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import apply_precision, parse_config
from ..io.image import read_image, to_numpy, to_tensor, write_image
from ..metrics import psnr
from ..runtime import load_model

NOISE_SIGMA = 0.0316


def degrade_noise(im: np.ndarray, seed: int = 0) -> np.ndarray:
    """``im`` plus N(0, NOISE_SIGMA^2) noise from a CPU generator, clipped
    to [0, 1]: the same numbers on every device."""
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn(im.shape, generator=gen).numpy()
    return np.clip(im + NOISE_SIGMA * noise, 0.0, 1.0).astype(np.float32)


@torch.no_grad()
def run(cfg, noised: bool = False) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    im, h, w = read_image(cfg.source)
    x_in = degrade_noise(im) if noised else im
    result = model(to_tensor(x_in, device), quant_mode="dequantize")
    x_hat = result["x_hat"].clamp(0.0, 1.0)
    out = cfg.target or "rec.png"
    write_image(to_numpy(x_hat), out, h, w)
    np.save(os.path.splitext(out)[0] + "_y_hat.npy", to_numpy(result["y_hat"]))
    if noised:
        write_image(x_in, os.path.splitext(out)[0] + "_in.png", h, w)
    p = float(psnr(x_hat, to_tensor(im, device)))
    print(f"{cfg.source} -> {out} psnr {p:.2f}")
    return {"psnr": p}


def main(argv=None):
    cfg = parse_config(argv)
    run(cfg, noised=(cfg.degrade == "noise"))


if __name__ == "__main__":
    main()
