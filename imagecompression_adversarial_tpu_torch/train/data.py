"""Host-side data pipeline: image folders -> shuffled random-crop batches
(port of ``imagecompression_adversarial_tpu/train/data.py``).

All of it is numpy, with the JAX package's seeds and draw order, so each
stream equals JAX's element for element: recursive folder listing of the
same five extensions (``.png .jpg .jpeg .bmp .webp``), a permutation an
epoch, one ``default_rng`` a file for its crop (drawn before the file is
read, so an unreadable file shifts no other crop), drop-last.  Files are
read through the port's own readers (``io/image.py::read_pixels``, no
PIL: PNG, JPEG, WebP, TIFF and GIF by the host C++ decoders, BMP by
numpy; the JPEG 2000 reader too, though no listed extension reaches it),
which give what JAX's ``Image.open(path).convert("RGB")`` gives
for every PNG kind, progressive, CMYK, YCCK and RGB-coded JPEGs at every
sampling, WebPs (an animated one's first frame) and palette, RLE and
bitfield BMPs included.
The decode threads run the decoders side by side (``ctypes`` drops the
GIL during each call), at most two batches a thread ahead of the consumer,
where JAX's stream submits a whole epoch at once: the same crops in the
same order, with memory bounded on a folder of any size.  A broken file or one smaller than the crop is
skipped, as the JAX loader skips a file PIL cannot open; an epoch that
yields no batch raises, naming what was skipped; so is a kind both refuse
(a hierarchical JPEG, ...).  A file that PIL reads and the port does not
(a lossless JPEG of subsampled components, a JPEG scan libjpeg decodes
with a warning, ...) raises, naming the file: JAX's stream holds it, so
skipping it would shift every later crop.

Without a data folder, ``synthetic_batches`` gives a deterministic
structured-noise stream.  Batches are (B, crop, crop, 3) float32 in [0, 1].
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import glob
import os
import queue
import struct
import threading
import zlib
from typing import Iterator, List, Optional

import numpy as np

from ..io.errors import RefusedByPillowError, UnsupportedImageError
from ..io.image import read_pixels

# the extensions the JAX package lists
_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_image_files(root: str) -> List[str]:
    """The image files under ``root``, recursively, sorted, as the JAX
    package lists them."""
    out = []
    for ext in _EXTS:
        out.extend(glob.glob(os.path.join(root, "**", f"*{ext}"), recursive=True))
    return sorted(out)


def _load_crop(path: str, crop: int, rng: np.random.Generator):
    """(crop, None), or (None, why the file was skipped).  Raises on a
    file that PIL reads and the port does not."""
    try:
        img = read_pixels(path)
    except RefusedByPillowError:
        return None, "refused by Pillow too"
    except UnsupportedImageError as e:
        raise UnsupportedImageError(
            f"{path}: {e}; the JAX loader reads it through PIL, so skipping it would shift "
            "the stream: convert it to PNG") from None
    except (OSError, ValueError, zlib.error, struct.error) as e:
        return None, f"unreadable ({type(e).__name__})"
    h, w, _ = img.shape
    if w < crop or h < crop:
        return None, f"smaller than the {crop}x{crop} crop"
    x0 = int(rng.integers(0, w - crop + 1))
    y0 = int(rng.integers(0, h - crop + 1))
    return img[y0:y0 + crop, x0:x0 + crop].astype(np.float32) / 255.0, None


def image_folder_batches(
    root: str,
    batch_size: int,
    crop: int = 256,
    seed: int = 0,
    workers: int = 8,
    epochs: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Yield (B, crop, crop, 3) float32 batches forever (or for ``epochs``).
    Raises ``FileNotFoundError`` when ``root`` holds no image,
    ``UnsupportedImageError`` on a file PIL reads and the port does not,
    and ``ValueError`` after an epoch that yields no batch.

    At most ``2 * workers * batch_size`` files (two batches a worker, the
    default prefetch of a ``DataLoader``) are submitted and not yet taken,
    so the crops held ahead of a slow consumer stay bounded.  Closing the
    generator cancels the queued decodes and waits only for those
    running."""
    files = list_image_files(root)
    if not files:
        raise FileNotFoundError(f"no {'/'.join(_EXTS)} images under {root}")
    rng = np.random.default_rng(seed)
    window = 2 * workers * batch_size

    def one_epoch():
        order = rng.permutation(len(files))
        seeds = [rng.integers(2**31) for _ in order]
        skipped = collections.Counter()
        yielded = 0
        pool = cf.ThreadPoolExecutor(max_workers=workers)
        pending: collections.deque = collections.deque()
        submitted = 0
        try:
            batch = []
            while submitted < len(order) or pending:
                while submitted < len(order) and len(pending) < window:
                    rng_file = np.random.default_rng(seeds[submitted])
                    pending.append(pool.submit(_load_crop, files[order[submitted]], crop, rng_file))
                    submitted += 1
                img, why = pending.popleft().result()
                if img is None:
                    skipped[why] += 1
                    continue
                batch.append(img)
                if len(batch) == batch_size:
                    yield np.stack(batch)
                    yielded += 1
                    batch = []
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        if not yielded:
            reasons = ", ".join(f"{n} {why}" for why, n in sorted(skipped.items()))
            kinds = "/".join(sorted({os.path.splitext(f)[1][1:].upper() for f in files}))
            raise ValueError(
                f"an epoch over the {len(files)} {kinds} files under {root} gave no batch of "
                f"{batch_size}: {sum(skipped.values())} skipped ({reasons or 'none'})")

    e = 0
    while epochs is None or e < epochs:
        yield from one_epoch()
        e += 1


def synthetic_batches(batch_size: int, crop: int = 256, seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic structured-noise batches (the fallback without data)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:crop, 0:crop].astype(np.float32)
    while True:
        phases = rng.uniform(0, 6.28, (batch_size, 3, 2)).astype(np.float32)
        freq = rng.uniform(0.02, 0.3, (batch_size, 3, 2)).astype(np.float32)
        imgs = []
        for b in range(batch_size):
            chans = [
                0.5
                + 0.35 * np.sin(xx * freq[b, c, 0] + phases[b, c, 0])
                * np.cos(yy * freq[b, c, 1] + phases[b, c, 1])
                for c in range(3)
            ]
            img = np.stack(chans, -1) + rng.normal(0, 0.03, (crop, crop, 3))
            imgs.append(np.clip(img, 0, 1).astype(np.float32))
        yield np.stack(imgs)


def make_batches(root: Optional[str], batch_size: int, crop: int = 256,
                 seed: int = 0) -> Iterator[np.ndarray]:
    """Image-folder stream if the directory holds images, else synthetic."""
    if root and os.path.isdir(root) and list_image_files(root):
        return image_folder_batches(root, batch_size, crop, seed)
    return synthetic_batches(batch_size, crop, seed)


def augment_dihedral(batches: Iterator[np.ndarray], seed: int = 0) -> Iterator[np.ndarray]:
    """A random dihedral transform (flips, rot90) of each image."""
    rng = np.random.default_rng(seed)
    for batch in batches:
        out = np.empty_like(batch)
        for i in range(batch.shape[0]):
            img = batch[i]
            k = rng.integers(0, 8)
            if k & 1:
                img = img[::-1, :, :]
            if k & 2:
                img = img[:, ::-1, :]
            if k & 4:
                img = np.rot90(img, 1, (0, 1))
            out[i] = img
        yield out


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a thread, ``depth`` items ahead.  An exception in the
    producer is raised here; closing this generator stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()
    failure = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            failure.append(e)
        put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=10)
