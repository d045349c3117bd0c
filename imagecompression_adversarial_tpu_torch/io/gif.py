"""GIF in host C++, without PIL: the first frame of a GIF file as Pillow's
``Image.open(path).convert("RGB")`` gives it, and the mode Pillow opens it
as.

``parse`` walks the blocks as Pillow's ``GifImagePlugin`` does for frame
0: the screen and its global colour table, then extensions (the graphic
control extension's transparency index; comments, application and unknown
extensions skipped with their sub-blocks) and stray bytes up to the first
image descriptor, its local colour table, its minimum code size and its
data sub-blocks (a sub-block the file cuts short is dropped, as Pillow's
decoder waits for whole ones).  A frame past the screen's edge widens the
canvas, as Pillow's does.  A colour table whose entries are all a gray
ramp (entry i is (i, i, i)) is no palette to Pillow: with no palette the
mode is ``L``, and the index is the gray level; else ``P``.

``decode_native`` fills the canvas with the transparency index (0
without one), as Pillow does for frame 0, and hands the LZW data to the
host C++ decoder (``csrc/gif.cc``, built with g++ on first use), which
writes the frame's indices into its rectangle, interlaced or not; they
are looked up in the frame's colour table (black past its end).  A broken
file raises ``ValueError``.  There is no numpy twin; Pillow is the
reference.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import Optional

import numpy as np

from .errors import check_size


@dataclasses.dataclass
class Gif:
    """The first frame of a GIF: the canvas, the frame's rectangle, its
    colour table (None: mode L), transparency index, interlacing, minimum
    code size and LZW data."""

    width: int
    height: int
    x0: int
    y0: int
    frame_w: int
    frame_h: int
    palette: Optional[bytes]
    transparency: Optional[int]
    interlace: bool
    bits: int
    lzw: bytes

    @property
    def mode(self) -> str:
        return "P" if self.palette else "L"


def _needed(table: bytes) -> bool:
    """Pillow's ``_is_palette_needed``: anything but a gray ramp."""
    if len(table) % 3:
        raise ValueError("GIF colour table is truncated")
    return any(not (i // 3 == table[i] == table[i + 1] == table[i + 2])
               for i in range(0, len(table), 3))


def parse(data: bytes) -> Gif:
    """The first frame of a GIF file; raises ``ValueError`` on a broken
    one."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file (no GIF87a or GIF89a header)")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 128:
        table = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(table)
        if _needed(table):
            global_palette = table

    def block():
        nonlocal pos
        if pos < len(data) and data[pos]:
            n = data[pos]
            body = data[pos + 1:pos + 1 + n]
            pos += 1 + n
            return body
        pos += 1
        return None

    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF file holds no image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension: its label, then sub-blocks
            if pos >= len(data):
                raise ValueError("GIF extension is truncated")
            label = data[pos]
            pos += 1
            body = block()
            if label == 0xF9 and body is not None:
                if len(body) < 4:
                    raise ValueError("GIF graphic control extension is truncated")
                if body[0] & 1:
                    transparency = body[3]
            while body:
                body = block()
        elif kind == 0x2C:  # the image descriptor
            if pos + 9 > len(data):
                raise ValueError("GIF image descriptor is truncated")
            x0, y0, fw, fh = struct.unpack_from("<HHHH", data, pos)
            flags = data[pos + 8]
            pos += 9
            palette = None
            if flags & 128:
                table = data[pos:pos + (3 << ((flags & 7) + 1))]
                pos += len(table)
                palette = table if _needed(table) else False
            if pos >= len(data):
                raise ValueError("GIF image data is truncated")
            bits = data[pos]
            pos += 1
            break
    chunks = []
    while pos < len(data) and data[pos]:
        n = data[pos]
        if pos + 1 + n > len(data):
            break  # a sub-block cut short: Pillow's decoder waits for it
        chunks.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    check_size("GIF", width, height)
    if fw == 0 or fh == 0:
        raise ValueError(f"GIF frame of {fw}x{fh} pixels")
    if not 1 <= bits <= 11:
        raise ValueError(f"GIF minimum code size {bits}")
    frame_palette = palette if palette is not None else global_palette
    return Gif(width, height, x0, y0, fw, fh, frame_palette or None, transparency,
               bool(flags & 64), bits, b"".join(chunks))


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_gif

    lib = ctypes.CDLL(str(build_gif()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.icat_gif_decode.restype = ctypes.c_int
    lib.icat_gif_decode.argtypes = [u8p, ctypes.c_int64] + [ctypes.c_int] * 8 + [
        u8p, ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_indices(g: Gif) -> np.ndarray:
    """(H, W) uint8 indices of the canvas after the first frame, by
    ``csrc/gif.cc``."""
    out = np.full((g.height, g.width), g.transparency or 0, np.uint8)
    lzw = np.frombuffer(g.lzw or b"\0", np.uint8)
    err = ctypes.create_string_buffer(256)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = _native().icat_gif_decode(lzw.ctypes.data_as(u8), len(g.lzw), g.bits, int(g.interlace),
                                   g.x0, g.y0, g.frame_w, g.frame_h, g.width, g.height,
                                   out.ctypes.data_as(u8), err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    return out


def decode_gif_native(g: Gif) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a parsed GIF's first frame."""
    idx = decode_indices(g)
    if not g.palette:
        return np.repeat(idx[..., None], 3, -1)
    n = len(g.palette) // 3
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = np.frombuffer(g.palette, np.uint8).reshape(n, 3)[:256]
    return lut[idx]


def decode_native(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a GIF file's first frame, as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder.  Raises what
    ``parse`` raises, ``ValueError`` on broken LZW data and
    ``RuntimeError`` where the decoder cannot be built."""
    return decode_gif_native(parse(data))
