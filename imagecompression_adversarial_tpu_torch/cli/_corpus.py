"""Corpus loop of the attack and evaluation CLIs (port of
``imagecompression_adversarial_tpu/cli/_corpus.py``): run a per-image
function over a source glob and print a line an image and the ``AVG:``
line."""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..io.image import list_images, read_image, to_numpy

Image = Tuple[str, np.ndarray, int, int]  # (name, (1, H, W, 3) array, h, w)


def corpus(source: str) -> Iterable[Image]:
    """The images of a ``-s`` glob; exits when it matches nothing."""
    files = list_images(source)
    if not files:
        raise SystemExit(f"no images match source glob {source!r}")
    for path in files:
        im, h, w = read_image(path)
        yield os.path.basename(path), im, h, w


def to_host(res: Dict[str, Any]) -> Dict[str, Any]:
    """Scalar tensors to floats, image tensors to (n, H, W, C) numpy; other
    values as they are."""
    return {k: (v.item() if v.dim() == 0 else to_numpy(v)) if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


def sync() -> None:
    """Wait for the card, where it is in use, so host clocks time its work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def run_corpus(
    source: str,
    per_image: Callable[[np.ndarray, int], Dict],
    fields=("bpp_ori", "bpp", "vi", "vi_msim"),
    images: Optional[Iterable[Image]] = None,
) -> Dict[str, float]:
    """Run ``per_image(image, index)`` over ``source`` (or over ``images``,
    given as ``(name, (1, H, W, 3) float32 array, h, w)``) and report."""
    sums = {k: 0.0 for k in fields}
    sums["t"] = 0.0
    n = 0
    for name, im, _, _ in (corpus(source) if images is None else images):
        sync()
        t0 = time.time()
        res = to_host(per_image(np.asarray(im, np.float32), n))
        dt = time.time() - t0
        parts = [f"{name}:"]
        for k in fields:
            if k in res:
                parts.append(f"{k} {float(res[k]):.4f}")
                sums[k] += float(res[k])
        parts.append(f"t {dt:.2f}s")
        print(" ".join(parts), flush=True)
        sums["t"] += dt
        n += 1
    if n == 0:
        raise SystemExit("no images to run")
    avg = {k: v / n for k, v in sums.items()}
    print("AVG: " + " ".join(f"{k} {v:.4f}" for k, v in avg.items()), flush=True)
    return avg
