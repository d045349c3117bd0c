"""Spatial tiling (port of ``imagecompression_adversarial_tpu/parallel/spatial.py``).

A megapixel image is split into 64-aligned tiles with overlap, the tile
batch is processed (split over the mesh's ``dp`` axis when given), and the
reconstructions are blended back with linear feathering.  The overlap
hides tile-boundary artifacts of the /16-downsampling codecs; the result
is an approximation (seams), unlike ``spatial_shard.py``'s exact rows.

``tile_image`` and ``untile_image`` are the JAX package's numpy, on NHWC
arrays; ``tiled_forward``'s ``apply_fn`` takes and returns NCHW tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import shard
from .mesh import mesh_device


def tile_image(
    x: np.ndarray, tile: int = 256, overlap: int = 64
) -> Tuple[np.ndarray, dict]:
    """Split (1, H, W, C) into overlapping (N, tile, tile, C) tiles.

    H, W must be multiples of 64 (pad-to-64 upstream); ``tile`` and
    ``overlap`` must be multiples of 64 so every tile stays codec-aligned.
    """
    if tile % 64 or overlap % 64 or overlap >= tile:
        raise ValueError(f"tile={tile} and overlap={overlap} must be multiples of 64, "
                         "overlap < tile")
    _, h, w, c = x.shape
    stride = tile - overlap
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if ys[-1] + tile < h:
        ys.append(h - tile)
    if xs[-1] + tile < w:
        xs.append(w - tile)
    tiles = np.stack([x[0, y0 : y0 + tile, x0 : x0 + tile] for y0 in ys for x0 in xs])
    meta = {"ys": ys, "xs": xs, "h": h, "w": w, "tile": tile}
    return tiles, meta


def untile_image(tiles: np.ndarray, meta: dict) -> np.ndarray:
    """Blend overlapping tiles back with linear feathering."""
    h, w, tile = meta["h"], meta["w"], meta["tile"]
    c = tiles.shape[-1]
    acc = np.zeros((h, w, c), np.float64)
    wsum = np.zeros((h, w, 1), np.float64)

    ramp = np.minimum(np.arange(1, tile + 1), np.arange(tile, 0, -1))
    ramp = np.minimum(ramp, tile // 4).astype(np.float64)  # plateau center
    wt = ramp[:, None] * ramp[None, :]
    wt = wt[..., None]

    k = 0
    for y0 in meta["ys"]:
        for x0 in meta["xs"]:
            acc[y0 : y0 + tile, x0 : x0 + tile] += tiles[k] * wt
            wsum[y0 : y0 + tile, x0 : x0 + tile] += wt
            k += 1
    return (acc / np.maximum(wsum, 1e-12)).astype(np.float32)[None]


def tiled_forward(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    x: np.ndarray,
    tile: int = 256,
    overlap: int = 64,
    mesh=None,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Run a reconstruction function over spatial tiles and return the
    blended reconstruction (``(1, H, W, C)`` numpy).  With a ``mesh`` the
    tiles are split over its ``dp`` axis (padded with copies of the last
    tile to an even split) and every rank returns the whole result; without
    one they run as one batch on ``device`` (the card by default)."""
    tiles, meta = tile_image(x, tile, overlap)
    n = len(tiles)
    if mesh is not None:
        dp = shard.mesh_axis(mesh, "dp")
        pad = (-n) % dp.size
        if pad:
            tiles = np.concatenate([tiles, np.repeat(tiles[-1:], pad, axis=0)])
        block = len(tiles) // dp.size
        mine = tiles[dp.index * block:(dp.index + 1) * block]
        out = apply_fn(torch.from_numpy(mine).permute(0, 3, 1, 2).to(mesh_device(mesh)))
        out = shard.gather(out.detach(), dp).reshape(-1, *out.shape[1:])[:n]
    else:
        device = torch.device("cuda") if device is None else device
        out = apply_fn(torch.from_numpy(tiles).permute(0, 3, 1, 2).to(device))
    return untile_image(out.detach().permute(0, 2, 3, 1).cpu().numpy(), meta)
