"""Pairwise image-quality comparison of two globs (port of
``imagecompression_adversarial_tpu/metrics/compare.py``): PSNR, MS-SSIM
and MS-SSIM in dB per pair and averaged."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..io.image import list_images, read_image, to_tensor
from .core import psnr
from .msssim import ms_ssim


@torch.no_grad()
def compare_pair(a: np.ndarray, b: np.ndarray, device="cuda") -> Dict[str, float]:
    """PSNR, MS-SSIM and -10 log10(1 - MS-SSIM) of two (1, H, W, 3)
    arrays in [0, 1], computed on ``device``."""
    xa, xb = to_tensor(a, device), to_tensor(b, device)
    msim = float(ms_ssim(xa, xb))
    return {
        "psnr": float(psnr(xa, xb)),
        "msim": msim,
        "msim_dB": float(-10.0 * np.log10(1.0 - msim)) if msim < 1.0 else np.inf,
    }


def compare_globs(glob_a: str, glob_b: str, device="cuda") -> Dict[str, float]:
    """Pairwise metrics over two sorted globs, which must match 1:1; prints
    a line a pair and the ``AVG:`` line."""
    files_a, files_b = list_images(glob_a), list_images(glob_b)
    if len(files_a) != len(files_b) or not files_a:
        raise ValueError(f"globs must match 1:1: {len(files_a)} vs {len(files_b)} files")
    sums = {"psnr": 0.0, "msim": 0.0, "msim_dB": 0.0}
    for fa, fb in zip(files_a, files_b):
        m = compare_pair(read_image(fa)[0], read_image(fb)[0], device)
        print(f"{os.path.basename(fa)} vs {os.path.basename(fb)}: "
              + " ".join(f"{k} {v:.4f}" for k, v in m.items()))
        for k in sums:
            sums[k] += m[k]
    avg = {k: v / len(files_a) for k, v in sums.items()}
    print("AVG: " + " ".join(f"{k} {v:.4f}" for k, v in avg.items()))
    return avg
