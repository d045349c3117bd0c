"""CLI: pairwise image-quality comparison of two globs on the GPU (port of
``imagecompression_adversarial_tpu/cli/compare.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.compare 'ori/*.png' 'rec/*.png'

Prints PSNR, MS-SSIM and MS-SSIM in dB a pair and their ``AVG:`` line.
"""

from __future__ import annotations

import argparse

from ..metrics.compare import compare_globs
from ..runtime import resolve_device


def run(args) -> dict:
    return compare_globs(args.glob_a, args.glob_b, resolve_device(args.device))


def main(argv=None):
    p = argparse.ArgumentParser(prog="compare", description=__doc__.splitlines()[0])
    p.add_argument("glob_a", help="first image glob (e.g. 'ori/*.png')")
    p.add_argument("glob_b", help="second image glob, pairwise vs the first")
    p.add_argument("-device", type=str, default="cuda", help="torch device: cuda (default) or cpu")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    main()
