"""Image IO with pad-to-multiple semantics (port of
``imagecompression_adversarial_tpu/io/image.py``).

Arrays are (1, H_pad, W_pad, 3) float32 numpy in [0, 1], as in the JAX
package; ``to_tensor`` makes the port's NCHW channels_last tensor.  No PIL:
``read_pixels`` tells the format by the file's first bytes and decodes

* PNG with numpy and ``zlib``: 8-bit, non-interlaced gray, RGB and RGBA
  files with any of the five scanline filters;
* JPEG with the host C++ baseline decoder (``io/jpeg.py::decode_native``,
  ``csrc/jpeg.cc``): gray, and YCbCr at 4:4:4, 4:2:2 or 4:2:0, the pixels
  Pillow's libjpeg gives;
* BMP (``BI_RGB``, 24- and 32-bit, bottom-up and top-down) with numpy.

What Pillow reads and these readers do not (a palette PNG or BMP, a
progressive JPEG, WebP, ...) raises ``UnsupportedImageError``, naming it; a
broken file raises ``ValueError``.  The writer emits 8-bit RGB PNGs.
"""

from __future__ import annotations

import glob as _glob
import struct
import zlib
from typing import Iterator, List, Tuple

import numpy as np
import torch

from .errors import UnsupportedImageError
from .jpeg import decode_native

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel, by PNG colour type, for the types the reader takes
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE_NAMES = {3: "palette", 4: "gray+alpha"}


def pad_to_multiple(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad an HWC image up to the next multiple along H and W."""
    h, w, c = img.shape
    hp = int(multiple * np.ceil(h / multiple))
    wp = int(multiple * np.ceil(w / multiple))
    out = np.zeros((hp, wp, c), dtype=img.dtype)
    out[:h, :w] = img
    return out


def _png_chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, body) of each chunk up to IEND, with its CRC checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        body = data[pos + 8:end - 4]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise ValueError("PNG file ends before its IEND chunk")


def _unfilter(kinds: np.ndarray, lines: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters (None, Sub, Up, Average, Paeth) of
    ``lines`` (h, stride) uint8, whose filter types are ``kinds`` (h,).

    A byte depends on the same byte of the pixel to its left (a), above (b)
    and above-left (c), so the pixels are rebuilt one anti-diagonal at a
    time: each needs only pixels of the two diagonals before it.
    """
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"PNG filter type {int(kinds.max())} is not one of the five")
    h, stride = lines.shape
    w = stride // bpp
    filt = lines.reshape(h, w, bpp).astype(np.int32)
    kinds = kinds.astype(np.int32)[:, None]
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # the filters read beyond the image's top and left edges
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[y]
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _decode_png(data: bytes) -> np.ndarray:
    """(H, W, channels) uint8 pixels of a PNG; raises ``ValueError`` naming
    what the reader does not take (palette, 16-bit, interlaced, ...)."""
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if colour in _COLOUR_TYPE_NAMES:
        raise UnsupportedImageError(f"{_COLOUR_TYPE_NAMES[colour]} PNGs are not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not valid")
    if depth != 8:
        raise UnsupportedImageError(f"{depth}-bit PNGs are not supported (8-bit only)")
    if interlace:
        raise UnsupportedImageError("interlaced PNGs are not supported")
    if compression or filter_method:
        raise ValueError("PNG compression or filter method is not 0")
    bpp = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not {h * (1 + w * bpp)}")
    lines = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    return _unfilter(lines[:, 0], lines[:, 1:], bpp)


def _encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8 pixels, every scanline filter 0."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (
        _PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + chunk(b"IEND", b"")
    )


# BMP compression codes (biCompression) the reader names when it refuses them
_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 3: "bitfields", 4: "JPEG-in-BMP", 5: "PNG-in-BMP",
                    6: "alpha bitfields"}


def _decode_bmp(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a ``BI_RGB`` BMP of 24 or 32 bits a pixel
    (the fourth byte ignored, as Pillow reads it), bottom-up or top-down."""
    if len(data) < 26:
        raise ValueError("BMP file is truncated")
    offset, header = struct.unpack("<II", data[10:18])
    if header == 12:  # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        compression = 0
    elif header in (40, 52, 56, 64, 108, 124) and len(data) >= 34:
        w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    else:
        raise ValueError(f"BMP header of {header} bytes is not valid")
    if bits <= 8:
        raise UnsupportedImageError(f"palette ({bits}-bit) BMPs are not supported "
                                    "(24- and 32-bit only)")
    if compression:
        name = _BMP_COMPRESSION.get(compression, f"compression {compression}")
        raise UnsupportedImageError(f"{name} BMPs are not supported (BI_RGB only)")
    if bits not in (24, 32):
        raise UnsupportedImageError(f"{bits}-bit BMPs are not supported (24- and 32-bit only)")
    top_down, h = h < 0, abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"BMP size {w}x{h} is not valid")
    bpp = bits // 8
    stride = (w * bpp + 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError("BMP pixel data is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    bgr = rows[:, :w * bpp].reshape(h, w, bpp)[..., 2::-1]
    return np.ascontiguousarray(bgr if top_down else bgr[::-1])


def _refuse(data: bytes) -> None:
    """Raise naming the format of an image file no reader here decodes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise UnsupportedImageError("WebP images are not supported (PNG, JPEG and BMP only)")
    for magic, name in ((b"GIF8", "GIF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF")):
        if data.startswith(magic):
            raise UnsupportedImageError(f"{name} images are not supported (PNG, JPEG and BMP "
                                        "only)")
    raise ValueError(f"not a PNG, JPEG or BMP file (it starts with {data[:8]!r})")


def read_pixels(path: str) -> np.ndarray:
    """An image file's (H, W, 3) uint8 RGB pixels, told apart by its first
    bytes (PNG, JPEG or BMP): gray is repeated into RGB, RGBA loses its
    alpha."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        img = _decode_png(data)
    elif data[:2] == b"\xff\xd8":
        img = decode_native(data)
    elif data[:2] == b"BM":
        img = _decode_bmp(data)
    else:
        _refuse(data)
    if img.shape[-1] == 1:
        img = np.tile(img, (1, 1, 3))
    return img[..., :3]


def read_image(path: str, padding: int = 64) -> Tuple[np.ndarray, int, int]:
    """Load a PNG, JPEG or BMP as (1, H_pad, W_pad, 3) float32 in [0, 1];
    returns ``(im, H, W)``.  Gray is repeated into RGB; RGBA loses its
    alpha."""
    img = read_pixels(path).astype(np.float32) / 255.0
    h, w, _ = img.shape
    return pad_to_multiple(img, padding)[None, ...], h, w


def write_image(x: np.ndarray, path: str, H: int | None = None, W: int | None = None) -> None:
    """Save a (1, H, W, 3) float array as an 8-bit RGB PNG cropped to (H, W)."""
    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    if H is None and W is None:
        H, W = arr.shape[0], arr.shape[1]
    out = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(_encode_png(np.ascontiguousarray(out[:H, :W, :])))


def list_images(pattern: str) -> List[str]:
    """Expand a source glob (the ``-s`` flag)."""
    return sorted(_glob.glob(pattern))


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """(1, h, w, 3) float32 in [0, 1] made with numpy from ``seed``: smooth
    gradients plus a little noise, a stand-in for a photo where no image
    files are at hand."""
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
