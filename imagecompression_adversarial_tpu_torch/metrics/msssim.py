"""Differentiable MS-SSIM on NCHW batches (port of
``imagecompression_adversarial_tpu/metrics/msssim.py``): 11-tap Gaussian
window (sigma 1.5) applied as two depthwise 1-D convolutions, a 5-level
pyramid with the standard weights, 2x average pooling between levels."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float32) - (win_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / np.sum(g)).astype(np.float32)


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise blur, valid padding."""
    c, k = x.shape[1], window.shape[0]
    x = F.conv2d(x, window.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, window.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_per_level(x, y, window, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = _blur(x, window), _blur(y, window)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _blur(x * x, window) - mu_xx
    sigma_yy = _blur(y * y, window) - mu_yy
    sigma_xy = _blur(x * y, window) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    s = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return s.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool after zero-padding H and W to even."""
    x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2))
    return F.avg_pool2d(x, 2)


def ms_ssim(x, y, data_range=1.0, win_size=11, win_sigma=1.5,
            weights=_MSSSIM_WEIGHTS, size_average=True):
    """Multi-scale SSIM; the pyramid keeps only the levels where the window
    still fits and renormalises their weights.  Per-level contrast terms
    pass a ReLU so the geometric mean stays real under attack."""
    window = torch.from_numpy(_gaussian_window(win_size, win_sigma)).to(x)
    min_side = min(x.shape[2], x.shape[3])
    levels = 1
    while levels < len(weights) and (min_side >> levels) >= win_size:
        levels += 1
    w = np.asarray(weights[:levels], np.float32)
    w = torch.from_numpy(w / w.sum()).to(x)
    mcs = []
    for i in range(levels):
        s, cs = _ssim_per_level(x, y, window, data_range)
        if i < levels - 1:
            mcs.append(F.relu(cs))
            x, y = _avg_pool2(x), _avg_pool2(y)
    stack = torch.stack(mcs + [F.relu(s)], dim=0)
    out = torch.prod(stack ** w[:, None], dim=0)
    return out.mean() if size_average else out
