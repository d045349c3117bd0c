"""CLI: write the 24-image synthetic corpus with the Kodak set's geometry,
with numpy and the port's own PNG writer (no PIL)::

    python -m imagecompression_adversarial_tpu_torch.cli.make_kodak24 [outdir]

``outdir`` defaults to ``./datasets/kodak``, where the attack CLIs' default
``-s`` glob looks.  18 landscape 768x512 images and 6 portrait 512x768 ones
(the portrait indices of the real set: 04, 09, 10, 17, 18, 19).  kodim03-24
cycle six kinds of content (smooth gradients with blobs, sinusoid
interference, checkers and stripes, filtered noise, radial waves,
piecewise-constant regions); kodim01/02 are the two-image recipe of the
repo's early runs.  The pixels are those of ``scripts/make_kodak24.py``:
the same draws from the same seeds, truncated to 8 bits as it does.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.image import write_image

PORTRAIT = (4, 9, 10, 17, 18, 19)


def _save(img: np.ndarray, path: str) -> None:
    """Truncate [0, 1] to 8 bits (``(img * 255).astype(uint8)``) and write
    those levels exactly."""
    levels = (img * 255).astype(np.uint8)
    write_image(levels.astype(np.float64) / 255.0, path)


def _legacy_two(outdir: str) -> None:
    rng = np.random.RandomState(0)
    for i in range(2):
        h, w = 512, 768
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.clip(
            np.stack([0.5 + 0.4 * np.sin(xx / 40.0 + i),
                      0.5 + 0.4 * np.cos(yy / 60.0),
                      0.5 + 0.2 * np.sin((xx + yy) / 30.0)], -1)
            + rng.rand(h, w, 3) * 0.05, 0, 1)
        _save(img, os.path.join(outdir, f"kodim{i + 1:02d}.png"))


def _content(i: int, h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """Image ``i``'s content before its noise, (h, w, 3) float64."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    k = i % 6
    if k == 0:
        img = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx * yy / (w * h) * 6)], -1)
        for _ in range(8):
            cy, cx, r = rng.rand() * h, rng.rand() * w, 30 + rng.rand() * 80
            img[..., rng.randint(3)] += 0.4 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        return img
    if k == 1:
        return np.stack([0.5 + 0.4 * np.sin(xx / (20 + 3 * i) + i),
                         0.5 + 0.4 * np.cos(yy / (30 + 2 * i)),
                         0.5 + 0.2 * np.sin((xx + yy) / (15 + i))], -1)
    if k == 2:
        return np.stack([((xx // (8 + i)) % 2) * 0.7 + 0.15,
                         ((yy // (12 + i)) % 2) * 0.6 + 0.2,
                         (((xx + yy) // (10 + i)) % 2) * 0.5 + 0.25], -1)
    if k == 3:
        from scipy.ndimage import gaussian_filter

        base = rng.rand(h, w, 3)
        img = np.stack([gaussian_filter(base[..., c], 1.5 + 0.5 * c) for c in range(3)], -1)
        return (img - img.min()) / (img.max() - img.min())
    if k == 4:
        cy, cx = h / 2 + rng.randn() * 60, w / 2 + rng.randn() * 60
        r = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        return np.stack([0.5 + 0.4 * np.sin(r / (8 + i % 7)),
                         0.5 + 0.4 * np.cos(r / (14 + i % 5)),
                         0.5 + 0.3 * np.sin(r / (20 + i % 9) + xx / w * 3)], -1)
    img = np.zeros((h, w, 3)) + rng.rand(3) * 0.3 + 0.2
    for _ in range(12):
        y0, x0 = rng.randint(h), rng.randint(w)
        hh, ww = rng.randint(40, h // 2), rng.randint(40, w // 2)
        img[y0:y0 + hh, x0:x0 + ww] = rng.rand(3)
    return img


def make_kodak24(outdir: str = "./datasets/kodak") -> None:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.RandomState(42)
    for i in range(1, 25):
        h, w = (768, 512) if i in PORTRAIT else (512, 768)
        img = np.clip(_content(i, h, w, rng) + rng.rand(h, w, 3) * 0.03, 0, 1)
        _save(img, os.path.join(outdir, f"kodim{i:02d}.png"))
    _legacy_two(outdir)  # kodim01/02: the early runs' images
    print(f"wrote 24 images -> {outdir}")


def main(argv=None) -> None:
    make_kodak24(*(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
