"""Input-transform defenses (port of
``imagecompression_adversarial_tpu/defenses/self_ensemble.py``): the
geometric self-ensemble, bit-depth reduction and bicubic resize.

The self-ensemble runs the codec on the 8 dihedral variants of the image
(identity and three flips, then the same four of the image rotated by 90
degrees), undoes each transform on its reconstruction and keeps the
variant closest to the input, with that variant's rate.  ``impl='batch'``
runs the two groups as two batches of 4 (the rotated group has H and W
swapped); ``impl='scan'`` runs one variant at a time, each under
``torch.utils.checkpoint``, so that a backward through the defense holds
one variant's activations at a time.  Everything is differentiable, so an
adaptive attack can optimize through the defense.

Under a row shard (``ops/shard.py``, the parallel layer's ``sp``) each
defense computes what the unsharded one computes.  The bit-depth
reduction is pointwise.  The resize reads rows across the blocks' edges,
and the rotated variants swap rows and columns, so those two gather the
3-channel image (``shard.shared_rows``, whose backward sums every rank's
gradient of a rank's rows), work on the whole image and keep this rank's
rows (``shard.own_rows``).  The ensemble runs the codec on each rank's
row block of each variant, gathers the 8 reconstructions, picks the
winner on the whole image (every rank picks the same) and keeps this
rank's rows of it; its rate sums the ranks' likelihoods.  At 4096x3072
in float32 a gathered image is 151 MB on every rank: the resize gathers
one a step, the ensemble nine (the input and 8 reconstructions, 1.36 GB)
and builds the 8 whole variants (1.21 GB), against the codec activations
of its 8 variants' blocks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import shard
from ..ops.bounds import ste_round

_LOG2 = math.log(2.0)


def dihedral_forward(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 8 dihedral variants of a ``(1, C, H, W)`` image: the flip group
    ``(4, C, H, W)`` and the rotated group ``(4, C, W, H)``."""
    if x.shape[0] != 1:
        raise ValueError("the dihedral ensemble operates on a single image")
    flips = torch.cat([x, x.flip(2), x.flip(3), x.flip(2, 3)])
    r = torch.rot90(x, 1, (2, 3))
    rots = torch.cat([r, r.flip(2), r.flip(3), r.flip(2, 3)])
    return flips, rots


def dihedral_inverse_group(x_hats_flip: torch.Tensor, x_hats_rot: torch.Tensor) -> torch.Tensor:
    """Undo the 8 transforms: ``(8, C, H, W)`` in the original orientation."""
    f, r = x_hats_flip, x_hats_rot
    inv_flips = [f[0], f[1].flip(1), f[2].flip(2), f[3].flip(1, 2)]
    inv_rots = [torch.rot90(v, -1, (1, 2)) for v in (r[0], r[1].flip(1), r[2].flip(2), r[3].flip(1, 2))]
    return torch.stack(inv_flips + inv_rots)


def _log_lik(likelihoods: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of the log-likelihoods of each element of a batch: (n,)."""
    return sum(torch.log(lik).flatten(1).sum(1) for lik in likelihoods.values())


def self_ensemble(
    apply_fn: Callable,
    x: torch.Tensor,
    quant_mode: str = "dequantize",
    impl: str = "batch",
) -> Dict[str, torch.Tensor]:
    """Geometric self-ensemble defense on a ``(1, C, H, W)`` image (this
    rank's rows of it under a row shard).

    ``apply_fn(im, quant_mode=...)`` is the codec's forward.  Returns
    ``x_hat`` (the winner, un-transformed and clamped to [0, 1]; this
    rank's rows under a row shard), its ``bpp``, ``best_idx`` and
    ``best_mse``; the winner is picked on the device (first minimum), with
    no host sync.
    """
    whole = shard.shared_rows(x)
    flips, rots = (shard.own_rows(v) for v in dihedral_forward(whole))
    num_pixels = whole.shape[2] * whole.shape[3]
    if impl == "scan":
        where = shard.current()

        def body(v):
            # the recompute runs on the autograd engine's thread for CUDA
            # tensors: it enters the row shard its forward ran under
            with shard.within(where):
                result = apply_fn(v, quant_mode=quant_mode)
            return result["x_hat"][0], _log_lik(result["likelihoods"])[0]

        outs = [checkpoint(body, flips[i:i + 1], use_reentrant=False) for i in range(4)]
        outs += [checkpoint(body, rots[i:i + 1], use_reentrant=False) for i in range(4)]
        log_lik = torch.stack([o[1] for o in outs])
        x_hats = (torch.stack([o[0] for o in outs[:4]]), torch.stack([o[0] for o in outs[4:]]))
    elif impl == "batch":
        res_f = apply_fn(flips, quant_mode=quant_mode)
        res_r = apply_fn(rots, quant_mode=quant_mode)
        log_lik = torch.cat([_log_lik(r["likelihoods"]) for r in (res_f, res_r)])
        x_hats = (res_f["x_hat"], res_r["x_hat"])
    else:
        raise ValueError(f"impl={impl!r} not in ['batch', 'scan']")
    bpps = shard.row_sum(log_lik) / (-_LOG2 * num_pixels)
    recon = dihedral_inverse_group(*(shard.shared_rows(v) for v in x_hats))
    mses = torch.mean((recon - whole) ** 2, dim=(1, 2, 3))
    best = torch.argmin(mses).reshape(1)
    return {
        "x_hat": shard.own_rows(torch.index_select(recon, 0, best)).clamp(0.0, 1.0),
        "bpp": bpps.index_select(0, best)[0],
        "best_idx": best[0],
        "best_mse": mses.index_select(0, best)[0],
    }


def bitdepth_reduction(
    x: torch.Tensor, bits: int = 6, inference: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reduce to ``bits`` of depth: round (identity gradient) or, with
    ``inference=False``, the dithered surrogate with uniform(-0.5, 0.5)
    noise from ``generator``."""
    scale = 2 ** bits - 1
    if inference:
        return ste_round(x * scale) / scale
    if generator is None:
        raise ValueError("the dithered bit-depth reduction needs a torch.Generator")
    noise = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) - 0.5
    return (x * scale + noise) / scale


def draw_resize_scale(seed: int) -> float:
    """The randomized resize factor, uniform(0.5, 0.75), drawn on the host
    with numpy (the same draw as the JAX package's)."""
    return float(np.random.default_rng(seed).uniform(0.5, 0.75))


def random_resize(x: torch.Tensor, scale: float = 243.0 / 256.0) -> Tuple[torch.Tensor, float]:
    """Bicubic (Keys a = -0.5) antialiased resize of an NCHW batch down by
    ``scale`` and back up to its size; under a row shard, of the whole
    images, returning this rank's rows."""
    whole = shard.shared_rows(x)
    h, w = whole.shape[2], whole.shape[3]
    down = F.interpolate(whole, size=(int(h * scale), int(w * scale)), mode="bicubic",
                         align_corners=False, antialias=True)
    up = F.interpolate(down, size=(h, w), mode="bicubic", align_corners=False, antialias=True)
    return shard.own_rows(up), scale


def make_defend_fn(apply_fn: Callable, method: str = "ensemble") -> Callable:
    """The evaluation's defense hook, ``x -> (x_hat, likelihoods)``; the
    ensemble's rate comes back ready as ``{'__bpp__': bpp}``."""
    if method == "ensemble":

        def defend(x):
            out = self_ensemble(apply_fn, x)
            return out["x_hat"], {"__bpp__": out["bpp"]}

    elif method in ("bitdepth", "resize"):
        transform = bitdepth_reduction if method == "bitdepth" else (lambda x: random_resize(x)[0])

        def defend(x):
            result = apply_fn(transform(x), quant_mode="dequantize")
            return result["x_hat"], result["likelihoods"]

    else:
        raise ValueError(f"{method!r} not in ['ensemble', 'resize', 'bitdepth']")
    return defend
