"""CLI: train the MLP classifier of classifier-targeted attacks on the GPU
(port of ``imagecompression_adversarial_tpu/cli/classifier_train.py``).

    python -m imagecompression_adversarial_tpu_torch.cli.classifier_train \\
        -steps 1001 [-s root/] [-ckpt out.msgpack] [-device cpu]

``-s`` names an image folder laid out as ``root/<label>/<image>``; without
one, a synthetic labeled stream (label-dependent stripes, numpy, equal to
the JAX package's) keeps the pipeline runnable.  The parameters go to
``-ckpt`` (default ``./ckpts/classifier.msgpack``) as a flax msgpack,
which ``attack_cv --cls_ckpt`` reads.

The JAX package reads the folder through PIL (``convert("RGB")`` and a
BICUBIC resize to 28x28).  This port has no PIL: it lists the same files,
decodes them with its own readers (``io/image.py::read_pixels``, the
pixels of Pillow's ``convert("RGB")``: every PNG kind, baseline,
progressive, CMYK, YCCK and RGB-coded JPEGs, WebPs, TIFFs and GIFs by the
host C++ decoders, every BMP kind; what they do not read raises, naming
it),
and resizes with ``pillow_bicubic_resize``, Pillow's two-pass fixed-point
resampling in numpy, which gives Pillow's bytes.
"""

from __future__ import annotations

import math
import os
from typing import Iterator, Tuple

import numpy as np

from ..config import apply_precision, parse_config
from ..io.image import read_pixels
from ..io.weights import flax_params, write_msgpack
from ..models.classifier import train_classifier
from ..runtime import resolve_device

_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit coefficients


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5) at float64 offsets."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index, fixed-point weights (out, ksize)) of each output
    pixel, as Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``
    compute them (support 2, widened by the scale when reducing)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic(((np.arange(xmax) + xmin) - center + 0.5) * (1.0 / filterscale))
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(w < 0, (-0.5 + fixed).astype(np.int64),
                                 (0.5 + fixed).astype(np.int64))
        starts[xx] = xmin
    return starts, kk


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of a uint8 (H, W, C) image, rounded to uint8
    between passes as Pillow does."""
    starts, kk = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    src = np.concatenate([src, np.zeros((kk.shape[1],) + src.shape[1:], np.int64)])
    idx = starts[:, None] + np.arange(kk.shape[1])[None, :]
    acc = np.einsum("ok,ok...->o...", kk, src[idx]) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pillow_bicubic_resize(img: np.ndarray, hw: int) -> np.ndarray:
    """A uint8 (H, W, 3) image resized to (hw, hw) as Pillow's
    ``Image.resize((hw, hw))`` (BICUBIC) does: the horizontal pass, then
    the vertical one, each skipped where the size already matches."""
    if img.shape[1] != hw:
        img = _resample(img, hw, 1)
    if img.shape[0] != hw:
        img = _resample(img, hw, 0)
    return img


def _image_folder_labeled(root: str, batch_size: int, hw: int = 28,
                          seed=0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    files = []
    for li, c in enumerate(classes):
        for f in os.listdir(os.path.join(root, c)):
            files.append((os.path.join(root, c, f), li))
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.choice(len(files), batch_size)
        xs, ys = [], []
        for i in idx:
            path, label = files[i]
            xs.append(pillow_bicubic_resize(read_pixels(path), hw).astype(np.float32) / 255.0)
            ys.append(label)
        yield np.stack(xs), np.asarray(ys, np.int32)


def _synthetic_labeled(batch_size: int, hw: int = 28,
                       seed=0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        ys = rng.integers(0, 10, batch_size)
        xs = np.zeros((batch_size, hw, hw, 3), np.float32)
        for i, y in enumerate(ys):  # label-dependent stripe pattern
            xs[i, :, :, :] = 0.1
            xs[i, y * 2: y * 2 + 3, :, :] = 0.9
        xs += rng.normal(0, 0.05, xs.shape).astype(np.float32)
        yield np.clip(xs, 0, 1), ys.astype(np.int32)


def run(cfg) -> float:
    apply_precision(cfg)
    device = resolve_device(cfg.device)
    root = cfg.source if os.path.isdir(cfg.source) else None
    batches = (_image_folder_labeled(root, cfg.batch_size) if root
               else _synthetic_labeled(cfg.batch_size))
    module, loss = train_classifier(batches, steps=cfg.steps, device=device)
    out = cfg.checkpoint or "./ckpts/classifier.msgpack"
    write_msgpack(out, flax_params(module))
    print(f"final loss {loss:.4f}; saved classifier -> {out}")
    return loss


def main(argv=None) -> float:
    return run(parse_config(argv))


if __name__ == "__main__":
    main()
