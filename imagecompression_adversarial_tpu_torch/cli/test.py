"""CLI: rate-distortion evaluation over an image corpus on the GPU (port of
``imagecompression_adversarial_tpu/cli/test.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.test -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' [--defend]

Prints bpp, PSNR, MS-SSIM and MS-SSIM in dB an image and their ``AVG:``
line; ``--defend`` evaluates through ``--defend_m``'s defense, and ``-q 0``
sweeps the family's qualities.
"""

from __future__ import annotations

import torch

from ..config import apply_precision, parse_config
from ..defenses import make_defend_fn
from ..io.image import to_tensor
from ..metrics import bpp_from_likelihoods, ms_ssim, psnr
from ..models import quality_range
from ..runtime import load_model
from ._corpus import run_corpus


def run(cfg) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    defend = make_defend_fn(model, cfg.method) if cfg.defend else None

    @torch.no_grad()
    def per_image(im, idx):
        x = to_tensor(im, device)
        if defend is not None:
            x_hat, lik = defend(x)
        else:
            result = model(x, quant_mode="dequantize")
            x_hat, lik = result["x_hat"], result["likelihoods"]
        x_hat = x_hat.clamp(0.0, 1.0)
        if "__bpp__" in lik:
            bpp = lik["__bpp__"]
        else:
            bpp = bpp_from_likelihoods(lik, x.shape[2] * x.shape[3])
        msim = ms_ssim(x_hat, x)
        return {"bpp": bpp, "psnr": psnr(x_hat, x), "msim": msim,
                "msim_dB": -10.0 * torch.log10(1.0 - msim)}

    return run_corpus(cfg.source, per_image, fields=("bpp", "psnr", "msim", "msim_dB"))


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.quality < 1:  # the quality sweep
        lo, hi = quality_range(cfg.model)
        for q in range(lo, hi + 1):
            cfg.quality = q
            print(f"== quality {q} ==")
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
