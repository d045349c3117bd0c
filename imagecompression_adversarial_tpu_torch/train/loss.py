"""Rate-distortion training loss (port of
``imagecompression_adversarial_tpu/train/loss.py``).

The rate is the sum of -log2 of the likelihoods, floored at 1/65536
through the gated ``lower_bound``, over the batch's pixels.  Distortion:
``mse`` -> lambda * 255^2 * MSE + bpp; ``ms-ssim`` -> lambda * (1 - MS-SSIM)
+ bpp; ``lpips`` -> lambda * LPIPS + bpp, where LPIPS defaults to the
port's seeded random features (``metrics/lpips.py``: not JAX's default).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional

import torch

from ..metrics import ms_ssim
from ..metrics.lpips import make_lpips_fn
from ..ops import shard
from ..ops.bounds import lower_bound

_LOG2 = math.log(2.0)
_LIK_FLOOR = 1.0 / 65536.0

# lambda tables, quality 1..8
LAMBDA_MSE = (0.0018, 0.0035, 0.0067, 0.0130, 0.0250, 0.0483, 0.0932, 0.1800)
LAMBDA_MSSSIM = (2.40, 4.58, 8.73, 16.64, 31.73, 60.50, 115.37, 220.00)


def lambda_for(metric: str, quality: int) -> float:
    table = LAMBDA_MSE if metric == "mse" else LAMBDA_MSSSIM
    return table[quality - 1]


@functools.lru_cache(maxsize=1)
def _default_lpips() -> Callable:
    return make_lpips_fn(seed=0)


def rate_distortion_loss(
    result: Dict[str, Any],
    target: torch.Tensor,
    lmbda: float,
    metric: str = "mse",
    perceptual_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """``{loss, bpp_loss, distortion}`` of a codec forward on ``target``
    (NCHW).  Under a row shard (``ops/shard.py``) the rate and the MSE are
    the whole image's; the other metrics raise there."""
    n, _, h, w = target.shape
    bpp = shard.row_sum(sum(torch.sum(torch.log(lower_bound(lik, _LIK_FLOOR)))
                            for lik in result["likelihoods"].values()))
    bpp = bpp / (-_LOG2 * n * h * w * shard.row_count())

    x_hat = result["x_hat"]
    if metric != "mse" and shard.row_axis() is not None:
        raise ValueError(f"metric {metric!r} has no row-sharded form; only 'mse' has")
    if metric == "mse":
        distortion = shard.mean((x_hat - target) ** 2)
        loss = lmbda * (255.0 ** 2) * distortion + bpp
    elif metric == "ms-ssim":
        distortion = 1.0 - ms_ssim(x_hat, target)
        loss = lmbda * distortion + bpp
    elif metric == "lpips":
        fn = perceptual_fn if perceptual_fn is not None else _default_lpips()
        distortion = fn(x_hat, target)
        loss = lmbda * distortion + bpp
    else:
        raise ValueError(f"metric {metric!r} not in ('mse', 'ms-ssim', 'lpips')")
    return {"loss": loss, "bpp_loss": bpp, "distortion": distortion}


def recompression_loss(g_a_fn: Callable, im0: torch.Tensor, im1: torch.Tensor,
                       lamb2: float = 0.01) -> torch.Tensor:
    """Latent-stability regularizer: ``lamb2`` times the L2 distance
    between the latents of ``im0`` and ``im1``."""
    return torch.sqrt(torch.sum((g_a_fn(im0) - g_a_fn(im1)) ** 2)) * lamb2
