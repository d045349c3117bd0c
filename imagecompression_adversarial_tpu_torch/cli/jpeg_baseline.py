"""CLI: JPEG baseline rate and distortion over a corpus (port of
``imagecompression_adversarial_tpu/cli/jpeg_baseline.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.jpeg_baseline 'kodim*.png' -q 50

Codes each image (PNG, JPEG, WebP, TIFF, GIF or BMP, read as Pillow's ``convert("RGB")``
reads it: ``io/image.py::read_pixels``) with the port's numpy baseline JPEG
encoder (``io/jpeg.py``: the bytes Pillow's libjpeg writes at that
quality, no PIL needed), decodes the bytes with its host C++ decoder (the
pixels Pillow's libjpeg decodes) and prints the real bpp, the decoded
image's PSNR and MS-SSIM (computed on the GPU) and the ``AVG:`` line.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io import jpeg
from ..io.image import list_images, read_pixels
from ..metrics.compare import compare_pair
from ..runtime import resolve_device


def run(args) -> dict:
    device = resolve_device(args.device)
    files = list_images(args.glob)
    if not files:
        raise SystemExit(f"no images match {args.glob!r}")
    sums = {"bpp": 0.0, "psnr": 0.0, "msim": 0.0}
    for f in files:
        rgb = read_pixels(f)
        data = jpeg.encode(rgb, args.quality)
        dec = jpeg.decode_native(data)
        m = compare_pair(rgb[None].astype(np.float32) / 255.0,
                         dec[None].astype(np.float32) / 255.0, device)
        bpp = len(data) * 8.0 / (rgb.shape[0] * rgb.shape[1])
        print(f"{f}: bpp {bpp:.4f} psnr {m['psnr']:.2f} msim {m['msim']:.4f}")
        sums["bpp"] += bpp
        sums["psnr"] += m["psnr"]
        sums["msim"] += m["msim"]
    avg = {k: v / len(files) for k, v in sums.items()}
    print("AVG: " + " ".join(f"{k} {v:.4f}" for k, v in avg.items()))
    return avg


def main(argv=None):
    p = argparse.ArgumentParser(prog="jpeg_baseline", description=__doc__.splitlines()[0])
    p.add_argument("glob", help="image glob (e.g. '/data/kodak/*.png')")
    p.add_argument("-q", dest="quality", type=int, default=50,
                   help="JPEG quality (default 50, the reference's setting)")
    p.add_argument("-device", type=str, default="cuda",
                   help="torch device for the metrics: cuda (default) or cpu")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
