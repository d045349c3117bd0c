"""CLI: Gaussian-noise and blur robustness evaluation on the GPU (port of
``imagecompression_adversarial_tpu/cli/random_noise.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.random_noise -m hyper -q 1 \\
        -ckpt ckpts/demo/hyper-q1-mse-synthetic.msgpack -s 'kodim*.png' -noise 1e-3
    # blur each image to the -noise MSE, into ./attack/blur/
    python -m ...cli.random_noise -s 'kodim*.png' -noise 1e-3 -degrade blurgen
    # the codec on the blurred images against the sharp ones
    python -m ...cli.random_noise -m hyper -q 1 -ckpt ... \\
        -s './attack/blur/*.png' -t 'kodim*.png' -degrade deblur

Prints the noise amplification ``vi_noise``, bpp, bpp_ori and PSNR an
image and their ``AVG:`` line; ``-q 0`` sweeps noise powers 1e-5 .. 1e-2
against the family's qualities.  Image ``i``'s noise comes from a
``torch.Generator`` seeded with ``i``: other noise than the JAX CLI's
``PRNGKey(i)``.
"""

from __future__ import annotations

import os

import torch

from ..analysis import calibrated_blur, make_deblur_eval_fn, make_noise_eval_fn
from ..config import apply_precision, parse_config
from ..io.image import list_images, read_image, to_numpy, to_tensor, write_image
from ..models import quality_range
from ..runtime import load_model, resolve_device
from ._corpus import run_corpus, to_host


def _blurgen(cfg) -> dict:
    """Blur each image of ``-s`` to the ``-noise`` MSE into ./attack/blur/."""
    device = resolve_device(cfg.device)
    out_dir = "./attack/blur/"
    os.makedirs(out_dir, exist_ok=True)
    for f in list_images(cfg.source):
        im, h, w = read_image(f)
        blurred, sigma = calibrated_blur(to_tensor(im, device), target_mse=cfg.noise)
        name = os.path.basename(f)
        write_image(to_numpy(blurred), out_dir + name, h, w)
        print(f"{name}: sigma {sigma:.3f} -> {out_dir + name}")
    return {}


def _deblur(cfg, model, device) -> dict:
    sharp_files = list_images(cfg.target or "")
    blur_files = list_images(cfg.source)
    if len(sharp_files) != len(blur_files):
        raise SystemExit("deblur mode needs matching -s (blur) and -t (sharp) globs")
    fn = make_deblur_eval_fn(model)
    sums = {"dpsnr": 0.0, "bpp": 0.0, "psnr_out": 0.0}
    for bf, sf in zip(blur_files, sharp_files):
        res = to_host(fn(to_tensor(read_image(bf)[0], device), to_tensor(read_image(sf)[0], device)))
        print(f"{bf}: " + " ".join(f"{k} {v:.4f}" for k, v in res.items()))
        for k in sums:
            sums[k] += res[k]
    avg = {k: v / len(blur_files) for k, v in sums.items()}
    print("AVG: " + " ".join(f"{k} {v:.4f}" for k, v in avg.items()))
    return avg


def run(cfg) -> dict:
    apply_precision(cfg)
    if cfg.degrade == "blurgen":
        return _blurgen(cfg)
    model = load_model(cfg)
    device = next(model.parameters()).device
    if cfg.degrade == "deblur":
        return _deblur(cfg, model, device)
    fn = make_noise_eval_fn(model)

    def per_image(im, idx):
        return fn(to_tensor(im, device), torch.Generator(device).manual_seed(idx), cfg.noise)

    return run_corpus(cfg.source, per_image, fields=("vi_noise", "bpp", "bpp_ori", "psnr"))


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.quality < 1:  # the noise x quality sweep
        lo, hi = quality_range(cfg.model)
        for noise in (1e-5, 1e-4, 1e-3, 1e-2):
            cfg.noise = noise
            for q in range(lo, hi + 1):
                cfg.quality = q
                print(f"== noise {noise} quality {q} ==")
                run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
