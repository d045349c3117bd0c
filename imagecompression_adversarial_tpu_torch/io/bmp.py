"""BMP in numpy, without PIL: every BMP kind Pillow's ``BmpImagePlugin``
opens, as its ``Image.open(path).convert("RGB")`` gives it, and the mode
it opens it as.

``decode`` reads the file header and the info header (``BITMAPCOREHEADER``
of 12 bytes, whose palette entries are 3 bytes, or the 40- to 124-byte
Windows headers, whose entries are 4), bottom-up or top-down rows, and:

* 1-, 4- and 8-bit palettes (``P``), where a palette of nothing but gray
  ramp entries opens as ``1`` (two entries, black and white) or ``L`` (the
  index is the gray level), as Pillow ditches such palettes; indices past
  the palette are black;
* ``BI_RLE8`` and ``BI_RLE4``, decoded as Pillow's own ``BmpRleDecoder``
  decodes them: runs clipped at the row's end, absolute runs not (an odd
  RLE4 run loses its last pixel), end-of-line padding the row with index
  0, end-of-bitmap, and the delta escape, which skips two bytes and reads
  its (right, up) from the two after them as that decoder does, leaving
  the pixels it passes at index 0; a bitmap the codes leave short of its
  rows raises, as Pillow's "not enough image data" does;
* 16-bit ``BI_RGB`` (5-5-5), 24- and 32-bit ``BI_RGB``;
* ``BI_BITFIELDS`` at 16, 24 and 32 bits for the masks Pillow accepts
  (5-6-5 and 5-5-5; whole bytes at 24 and 32 bits, with an alpha mask in
  a header of 56 bytes or more, which opens as ``RGBA``); 5-bit and 6-bit
  fields scale by ``v * 255 // 31`` and ``v * 255 // 63``.

What Pillow refuses raises ``ValueError``, as Pillow raises: another
depth, another mask, ``BI_JPEG``, ``BI_PNG``, ``BI_ALPHABITFIELDS``, RLE
codes at another depth than theirs, a palette of more than 256 entries
(its "invalid palette size"), a gray ramp palette on rows of other than
its own depth (which Pillow would unpack in another mode).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from .errors import check_size

# Windows info header sizes Pillow reads
_HEADERS = (40, 52, 56, 64, 108, 124)
_COMPRESSIONS = {0: "BI_RGB", 1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG",
                 5: "BI_PNG", 6: "BI_ALPHABITFIELDS"}
# the masks Pillow's plugin accepts -> its raw mode
_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
def _u32(data: bytes, at: int) -> int:
    if at + 4 > len(data):
        raise ValueError("BMP header is truncated")
    return struct.unpack_from("<I", data, at)[0]


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """The indices of an RLE8 or RLE4 bitmap from ``pos``, in file row
    order, as Pillow's ``BmpRleDecoder`` gives them."""
    out = bytearray()
    x, need, end = 0, w * h, len(data)
    while len(out) < need:
        if pos + 2 > end:
            break
        n, byte = data[pos], data[pos + 1]
        pos += 2
        if n:  # a run of n pixels, clipped at the row's end
            n = max(0, w - x) if x + n > w else n
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(n))
            else:
                out += bytes((byte,)) * n
            x += n
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow reads two bytes, then (right, up) from two more
            if pos + 2 > end:
                break
            if pos + 4 > end:
                raise ValueError("BMP RLE delta is truncated")
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # an absolute run of `byte` pixels
            count = byte // 2 if rle4 else byte
            chunk = data[pos:pos + count]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < count:
                break
            x += byte
            pos += pos % 2  # to a 16-bit boundary of the file
    if len(out) < need:
        raise ValueError("BMP RLE data ends before its last row (not enough image data)")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w)


def _unpack(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, w) indices of (h, stride) rows of 1, 4 or 8 bits a pixel, high
    bits first."""
    if bits == 8:
        return rows[:, :w]
    bits_ = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bits)
    return (bits_ << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)[:, :w]


def decode(data: bytes) -> Tuple[np.ndarray, str]:
    """(H, W, 3) uint8 RGB pixels of a BMP file, as Pillow's
    ``convert("RGB")`` gives them, and the mode Pillow opens it as."""
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError("not a BMP file (no BM signature)")
    offset, header = _u32(data, 10), _u32(data, 14)
    if header == 12:  # BITMAPCOREHEADER: no compression, 3-byte palette entries
        if len(data) < 26:
            raise ValueError("BMP header is truncated")
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, padding, top_down = 0, 0, 3, False
    elif header in _HEADERS:
        if len(data) < 14 + header:
            raise ValueError("BMP header is truncated")
        top_down = data[25] == 0xFF
        w, h = _u32(data, 18), _u32(data, 22)
        h = 2 ** 32 - h if top_down else h
        bits = struct.unpack_from("<H", data, 28)[0]
        compression, colors, padding = _u32(data, 30), _u32(data, 46), 4
    else:
        raise ValueError(f"BMP header of {header} bytes is not one Pillow reads")
    check_size("BMP", w, h)
    colors = colors or (1 << bits)
    if offset == 14 + header and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP pixel depth {bits} is not one Pillow reads")
    mode, raw = ("P", None) if bits <= 8 else ("RGB", {16: "BGR;15", 24: "BGR", 32: "BGRX"}[bits])
    if compression == 3:
        masks = [_u32(data, 54 + 4 * i) for i in range(3)]
        masks.append(_u32(data, 66) if header >= 56 else 0)
        key = (bits, tuple(masks if bits == 32 else masks[:3]))
        if key not in _MASKS:
            raise ValueError(f"BMP bitfields {[hex(m) for m in key[1]]} at {bits} bits are not a "
                             "layout Pillow reads")
        raw = _MASKS[key]
        mode = "RGBA" if "A" in raw else mode
    elif compression in (1, 2):
        if bits != (8 if compression == 1 else 4):
            raise ValueError(f"{_COMPRESSIONS[compression]} BMP of {bits} bits a pixel")
    elif compression:
        raise ValueError(f"BMP compression {_COMPRESSIONS.get(compression, compression)} is not "
                         "one Pillow reads")
    lut = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} entries")
        table = data[14 + header:14 + header + padding * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(table[i * padding:i * padding + 3] == bytes((v & 255,)) * 3
               for i, v in enumerate(ramp)):
            mode = "1" if colors == 2 else "L"
            if (mode == "1" and compression) or (not compression and
                                                 bits != (1 if mode == "1" else 8)):
                raise ValueError(f"{bits}-bit {'RLE ' if compression else ''}BMP with a gray "
                                 f"ramp palette of {colors} entries")
        else:
            if colors > 256:
                raise ValueError(f"BMP palette of {colors} entries (256 at most)")
            n = len(table) // padding
            lut = np.zeros((256, 3), np.uint8)
            lut[:n] = np.frombuffer(table, np.uint8, n * padding).reshape(n, padding)[:, 2::-1]
    if compression in (1, 2):
        idx = _rle(data, offset, w, h, compression == 2)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if offset + stride * h > len(data):
            raise ValueError("BMP pixel data is truncated")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
        if bits <= 8:
            idx = _unpack(rows, w, bits)
        elif bits == 16:
            px = rows[:, :2 * w].reshape(h, w, 2).astype(np.int64)
            v = px[..., 0] | px[..., 1] << 8
            if raw == "BGR;16":
                rgb = np.stack([(v >> 11 & 31) * 255 // 31, (v >> 5 & 63) * 255 // 63,
                                (v & 31) * 255 // 31], -1)
            else:
                rgb = np.stack([(v >> 10 & 31) * 255 // 31, (v >> 5 & 31) * 255 // 31,
                                (v & 31) * 255 // 31], -1)
            idx = rgb.astype(np.uint8)
        else:
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
            idx = px[..., [raw.index(c) for c in "RGB"]]
    if mode == "P":
        rgb = lut[idx]
    elif mode == "1":
        rgb = np.repeat((idx * 255)[..., None], 3, -1).astype(np.uint8)
    elif mode == "L":
        rgb = np.repeat(idx[..., None], 3, -1)
    else:
        rgb = idx
    return np.ascontiguousarray(rgb if top_down else rgb[::-1]), mode
