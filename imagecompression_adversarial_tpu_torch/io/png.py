"""PNG in numpy and host C++, without PIL: every PNG kind's pixels as
Pillow's ``Image.open(path).convert("RGB")`` gives them, and the writer of
the port's 8-bit RGB PNGs.

``parse`` walks the chunks up to IEND with their CRCs checked, reads IHDR
and PLTE, inflates the IDAT stream with ``zlib`` and checks its length.
``decode_native`` turns the inflated bytes into pixels with the host C++
decoder (``csrc/png.cc``, built with g++ on first use): the five scanline
filters, Adam7 deinterlacing, bit depths 1, 2, 4, 8 and 16, colour types
0, 2, 3, 4 and 6, and the conversion to RGB of the mode Pillow opens each
kind as (``MODES``): gray 1-bit to 0 or 255, 2-bit times 85, 4-bit times
17, 16-bit (``I;16``) clipped to 255; 16-bit RGB, RGBA and gray+alpha by
their high bytes; alpha dropped; palette indices through PLTE, black past
its end.  ``decode`` is its plain numpy version, the same pixels, whose
unfilter rebuilds a pass one anti-diagonal at a time, many times slower
(``chip_smoke.py`` phase 22a times both).  A library that cannot be built
raises; nothing falls back to the numpy version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
import zlib
from typing import Iterator, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Pillow's mode of each (bit depth, colour type) PNG allows
MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
         (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
         (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
# samples a pixel, by colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_WHOLE = ((0, 0, 1, 1),)


@dataclasses.dataclass
class Png:
    """A PNG's header, palette (PLTE's body, empty without one) and image
    data once inflated."""

    width: int
    height: int
    depth: int
    colour: int
    interlace: int
    palette: bytes
    raw: bytes

    @property
    def mode(self) -> str:
        """The mode Pillow opens the file as."""
        return MODES[(self.depth, self.colour)]

    def passes(self) -> Iterator[Tuple[int, int, int, int, int, int]]:
        """(first column, first row, column step, row step, columns, rows)
        of each pass that holds pixels: the whole image, or Adam7's seven."""
        for x0, y0, dx, dy in _ADAM7 if self.interlace else _WHOLE:
            pw, ph = -(-(self.width - x0) // dx), -(-(self.height - y0) // dy)
            if pw > 0 and ph > 0:
                yield x0, y0, dx, dy, pw, ph

    def stride(self, columns: int) -> int:
        """Bytes of a row of ``columns`` pixels, its filter byte aside."""
        return -(-columns * CHANNELS[self.colour] * self.depth // 8)


def _chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, body) of each chunk up to IEND, with its CRC checked."""
    if data[:8] != SIGNATURE:
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


def parse(data: bytes) -> Png:
    """The header, palette and inflated image data of a PNG file; raises
    ``ValueError`` on a broken one."""
    header, palette, idat = None, b"", []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR chunk of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, colour, compression, filter_method, interlace = header
    if (depth, colour) not in MODES:
        raise ValueError(f"PNG bit depth {depth} is not valid for colour type {colour}")
    if compression or filter_method or interlace > 1:
        raise ValueError("PNG compression, filter or interlace method is not one PNG defines")
    if w == 0 or h == 0:
        raise ValueError(f"PNG size {w}x{h} is not valid")
    if colour == 3 and not palette:
        raise ValueError("palette PNG has no PLTE chunk")
    png = Png(w, h, depth, colour, interlace, palette, zlib.decompress(b"".join(idat)))
    need = sum(ph * (1 + png.stride(pw)) for *_, pw, ph in png.passes())
    if len(png.raw) != need:
        raise ValueError(f"PNG image data holds {len(png.raw)} bytes, not {need}")
    return png


def _unfilter(kinds: np.ndarray, lines: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the scanline filters (None, Sub, Up, Average, Paeth) of
    ``lines`` (h, stride) uint8, whose filter types are ``kinds`` (h,),
    with ``bpp`` bytes a pixel (1 below 8 bits a pixel).

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
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def _samples(rows: np.ndarray, columns: int, channels: int, depth: int) -> np.ndarray:
    """(rows, columns, channels) int64 samples of unfiltered rows: 16-bit
    big endian, or sub-byte samples packed from each byte's high bit."""
    if depth == 16:
        pairs = rows.reshape(rows.shape[0], -1, 2).astype(np.int64)
        flat = (pairs[..., 0] << 8) | pairs[..., 1]
    elif depth == 8:
        flat = rows.astype(np.int64)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth).astype(np.int64)
        flat = (bits << np.arange(depth - 1, -1, -1)).sum(-1)
    return flat[:, :columns * channels].reshape(rows.shape[0], columns, channels)


def _rgb(png: Png, s: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB of (..., channels) samples, as Pillow converts
    the mode it opens ``png`` as."""
    if png.colour == 3:
        lut = np.zeros((256, 3), np.int64)
        entries = np.frombuffer(png.palette[:3 * (len(png.palette) // 3)], np.uint8)[:768]
        lut[:entries.size // 3] = entries.reshape(-1, 3)
        return lut[s[..., 0]].astype(np.uint8)
    if png.colour in (2, 6):
        rgb = s[..., :3]
        return (rgb >> 8 if png.depth == 16 else rgb).astype(np.uint8)
    g = s[..., 0]
    if png.colour == 4:
        g = g >> 8 if png.depth == 16 else g
    else:
        g = np.minimum(g, 255) if png.depth == 16 else g * (255 // ((1 << png.depth) - 1))
    return np.repeat(g[..., None], 3, -1).astype(np.uint8)


def decode_png(png: Png) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a parsed PNG: the plain numpy version
    of ``decode_png_native``."""
    out = np.zeros((png.height, png.width, 3), np.uint8)
    bits = CHANNELS[png.colour] * png.depth
    pos = 0
    for x0, y0, dx, dy, pw, ph in png.passes():
        stride = png.stride(pw)
        lines = np.frombuffer(png.raw, np.uint8, ph * (1 + stride), pos).reshape(ph, 1 + stride)
        pos += ph * (1 + stride)
        rows = _unfilter(lines[:, 0], lines[:, 1:], max(1, bits // 8))
        out[y0::dy, x0::dx] = _rgb(png, _samples(rows, pw, CHANNELS[png.colour], png.depth))
    return out


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a PNG file, as Pillow's
    ``convert("RGB")`` gives them: the plain numpy version of
    ``decode_native``."""
    return decode_png(parse(data))


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_png

    lib = ctypes.CDLL(str(build_png()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.icat_png_decode.restype = ctypes.c_int
    lib.icat_png_decode.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u8p, ctypes.c_int, u8p, ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_png_native(png: Png) -> np.ndarray:
    """``decode_png`` by the host C++ decoder (``csrc/png.cc``)."""
    raw = np.frombuffer(png.raw or b"\0", np.uint8)
    palette = np.frombuffer(png.palette or b"\0", np.uint8)
    out = np.empty((png.height, png.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = _native().icat_png_decode(
        raw.ctypes.data_as(u8), len(png.raw), png.width, png.height, png.depth, png.colour,
        png.interlace, palette.ctypes.data_as(u8), len(png.palette), out.ctypes.data_as(u8),
        err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    return out


def decode_native(data: bytes) -> np.ndarray:
    """``decode`` by the host C++ decoder (``csrc/png.cc``, built with g++
    on first use): the same pixels, bit for bit.  Raises what ``parse``
    raises, ``ValueError`` on a bad filter type, and ``RuntimeError``
    where the decoder cannot be built."""
    return decode_png_native(parse(data))


def encode(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8 pixels, every scanline filter 0."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (
        SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + _chunk(b"IEND", b"")
    )


def _chunk(kind: bytes, body: bytes) -> bytes:
    """A PNG chunk: length, type, body and CRC."""
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

