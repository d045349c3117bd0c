"""Distribution-level metrics: FID, KID (polynomial-kernel MMD) and the
Inception Score, for any feature extractor (port of
``imagecompression_adversarial_tpu/metrics/fid.py``).

The metric math is numpy and scipy, as in the JAX package.  The default
feature extractor, where no pretrained network is at hand, is a random
conv net: three 3x3 stride-2 convs with
flax's ``"SAME"`` padding (for stride 2: one row and column of zeros at the
bottom and right of an even size, one on each side of an odd size), ReLU,
and a global mean.  ``make_conv_feature_fn`` draws its kernels from a
``torch.Generator``, so its features are not the JAX package's (which draws
from ``jax.random``); ``conv_feature_fn_from_kernels`` takes given HWIO
kernels, so both packages can compute the same features.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets: ||mu_a - mu_b||^2 +
    Tr(Ca + Cb - 2 sqrt(Ca Cb))."""
    if feats_a.shape[0] < 2 or feats_b.shape[0] < 2:
        # np.cov squeezes a (1, D) input into a one-variable series: a wrong
        # covariance, not just a degenerate one
        raise ValueError("FID needs >= 2 samples in each set")
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)
    covmean = linalg.sqrtm(cov_a @ cov_b)
    if isinstance(covmean, tuple):  # older scipy returned (sqrtm, errest)
        covmean = covmean[0]
    if not np.all(np.isfinite(covmean)):
        # rank-deficient covariances (N-1 < D): the original FID's eps*I jitter
        eps = 1e-6 * np.eye(cov_a.shape[0])
        covmean = linalg.sqrtm((cov_a + eps) @ (cov_b + eps))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a + cov_b - 2.0 * covmean))


def _poly_kernel(x: np.ndarray, y: np.ndarray, degree=3, gamma=None, coef0=1.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef0) ** degree


def kid(
    feats_a: np.ndarray,
    feats_b: np.ndarray,
    n_subsets: int = 10,
    subset_size: int = 100,
    seed: int = 0,
    degree: int = 3,
    gamma: float | None = None,
    coef0: float = 1.0,
) -> Tuple[float, float]:
    """Kernel Inception Distance: the unbiased polynomial-kernel MMD^2 over
    random subsets (mean, std)."""
    rng = np.random.RandomState(seed)
    m = min(subset_size, feats_a.shape[0], feats_b.shape[0])
    vals = []
    for _ in range(n_subsets):
        xa = feats_a[rng.choice(feats_a.shape[0], m, replace=False)]
        xb = feats_b[rng.choice(feats_b.shape[0], m, replace=False)]
        k_aa = _poly_kernel(xa, xa, degree, gamma, coef0)
        k_bb = _poly_kernel(xb, xb, degree, gamma, coef0)
        k_ab = _poly_kernel(xa, xb, degree, gamma, coef0)
        np.fill_diagonal(k_aa, 0)
        np.fill_diagonal(k_bb, 0)
        vals.append(k_aa.sum() / (m * (m - 1)) + k_bb.sum() / (m * (m - 1)) - 2.0 * k_ab.mean())
    return float(np.mean(vals)), float(np.std(vals))


def inception_score(probs: np.ndarray, n_splits: int = 10) -> Tuple[float, float]:
    """IS from class probabilities (N, K): exp(E_x KL(p(y|x) || p(y)))."""
    scores = []
    for chunk in np.array_split(probs, n_splits):
        py = chunk.mean(0, keepdims=True)
        kl = chunk * (np.log(chunk + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _same_pad(size: int, stride: int = 2, kernel: int = 3) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding (before, after) of one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_feature_fn_from_kernels(kernels: Sequence[np.ndarray], device="cuda") -> Callable:
    """``(N, H, W, 3)`` numpy images -> ``(N, D)`` numpy features of the
    conv net with the given HWIO kernels, run on ``device``."""
    weights = [torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)), np.float32))
               .to(device) for k in kernels]

    @torch.no_grad()
    def features(x: np.ndarray) -> np.ndarray:
        h = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).permute(0, 3, 1, 2)
        for w in weights:
            top, bottom = _same_pad(h.shape[2])
            left, right = _same_pad(h.shape[3])
            h = F.relu(F.conv2d(F.pad(h, (left, right, top, bottom)), w, stride=2))
        return torch.mean(h, dim=(2, 3)).cpu().numpy()

    return features


def conv_kernels(dim: int = 64, seed: int = 0) -> list:
    """The random net's HWIO kernels: widths 16, 32, ``dim``, standard
    normal over sqrt(9 x fan-in), drawn from a ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    kernels, in_ch = [], 3
    for width in (16, 32, dim):
        k = torch.randn((3, 3, in_ch, width), generator=gen) / np.sqrt(9 * in_ch)
        kernels.append(k.numpy())
        in_ch = width
    return kernels


def make_conv_feature_fn(dim: int = 64, seed: int = 0, device="cuda") -> Callable:
    """The seeded random conv feature extractor (the default where no
    pretrained network is at hand)."""
    return conv_feature_fn_from_kernels(conv_kernels(dim, seed), device)


def features_over(images: Iterable[np.ndarray], feature_fn: Callable) -> np.ndarray:
    return np.concatenate([feature_fn(im) for im in images], axis=0)
