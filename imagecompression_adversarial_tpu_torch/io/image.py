"""Image IO with pad-to-multiple semantics (port of
``imagecompression_adversarial_tpu/io/image.py``).

Arrays are (1, H_pad, W_pad, 3) float32 numpy in [0, 1], as in the JAX
package; ``to_tensor`` makes the port's NCHW channels_last tensor.  PIL is
imported only inside the functions that read or write PNGs.
"""

from __future__ import annotations

import glob as _glob
from typing import List, Tuple

import numpy as np
import torch


def pad_to_multiple(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad an HWC image up to the next multiple along H and W."""
    h, w, c = img.shape
    hp = int(multiple * np.ceil(h / multiple))
    wp = int(multiple * np.ceil(w / multiple))
    out = np.zeros((hp, wp, c), dtype=img.dtype)
    out[:h, :w] = img
    return out


def read_image(path: str, padding: int = 64) -> Tuple[np.ndarray, int, int]:
    """Load a PNG as (1, H_pad, W_pad, 3) float32 in [0, 1]; returns
    ``(im, H, W)``."""
    from PIL import Image

    img = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w, _ = img.shape
    return pad_to_multiple(img, padding)[None, ...], h, w


def write_image(x: np.ndarray, path: str, H: int | None = None, W: int | None = None) -> None:
    """Save a (1, H, W, 3) float array as an 8-bit PNG cropped to (H, W)."""
    from PIL import Image

    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    if H is None and W is None:
        H, W = arr.shape[0], arr.shape[1]
    out = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(out[:H, :W, :]).save(path)


def list_images(pattern: str) -> List[str]:
    """Expand a source glob (the ``-s`` flag)."""
    return sorted(_glob.glob(pattern))


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """(1, h, w, 3) float32 in [0, 1] made with numpy from ``seed``: smooth
    gradients plus a little noise, a stand-in for a photo where no image
    files or PIL are at hand."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 40.0 + seed),
            0.5 + 0.4 * np.cos(yy / 60.0),
            0.5 + 0.2 * np.sin((xx + yy) / 30.0),
        ],
        -1,
    ) + 0.05 * rng.rand(h, w, 3)
    return np.clip(img, 0.0, 1.0).astype(np.float32)[None]


def to_tensor(im: np.ndarray, device) -> torch.Tensor:
    """(n, H, W, 3) numpy -> (n, 3, H, W) float32 channels_last tensor."""
    t = torch.from_numpy(np.ascontiguousarray(im, np.float32)).to(device)
    return t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """(n, C, H, W) tensor -> (n, H, W, C) numpy."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()
