"""CLI: recompression stability on the GPU (port of
``imagecompression_adversarial_tpu/cli/recompression.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.recompression -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' -re 50 [--defend]

Re-encodes each image ``-re`` times (``-steps`` without it), rounding the
output to 8 bits each cycle, and prints the last cycle's bpp and the PSNR
and MS-SSIM of the last output against the original; ``--defend`` runs the
self-ensemble in every cycle.
"""

from __future__ import annotations

from ..analysis import make_recompression_fn
from ..config import apply_precision, parse_config
from ..io.image import to_tensor
from ..runtime import load_model
from ._corpus import run_corpus


def run(cfg) -> dict:
    apply_precision(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    repeats = cfg.recompress or cfg.steps
    if cfg.defend:
        print("Self Ensemble Applied!")
    fn = make_recompression_fn(model, repeats=repeats, defend="ensemble" if cfg.defend else None)

    def per_image(im, idx):
        res = fn(to_tensor(im, device))
        return {k: v for k, v in res.items() if k != "bpp_trajectory"}

    return run_corpus(cfg.source, per_image, fields=("bpp", "psnr", "msim", "msim_dB"))


def main(argv=None):
    run(parse_config(argv))


if __name__ == "__main__":
    main()
