"""WebP in host C++, without PIL: a still WebP's pixels as Pillow's
``Image.open(path).convert("RGB")`` gives them.

``parse`` walks the RIFF container: its size field (bytes past it are
ignored, a file shorter than it is truncated), each chunk's size and its
padding to an even length, ``VP8X`` (the canvas size and the alpha and
animation flags) and the image chunk, ``VP8 `` (lossy) or ``VP8L``
(lossless), whose header it reads for the size.  ``ALPH``, ``ICCP``,
``EXIF``, ``XMP `` and unknown chunks are skipped: Pillow's RGB does not
depend on them (libwebp decodes unpremultiplied RGBA, so its colour does
not depend on alpha).  An animated file (``ANIM``/``ANMF`` chunks or the
``VP8X`` animation flag) raises ``UnsupportedImageError``; a broken
container raises ``ValueError``.  The mode is Pillow's: ``RGBA`` where
libwebp's features report alpha (the ``VP8L`` header's alpha bit for a
lossless file; the ``VP8X`` alpha flag for a lossy one; an ``ALPH`` chunk
for either), else ``RGB``.

``decode_native`` hands the image chunk to the host C++ decoder
(``csrc/webp.cc``, built with g++ on first use): VP8L with its prefix
codes, color cache, LZ77 copies and four transforms, and VP8 key frames
per RFC 6386 to Y/U/V planes (segments, token partitions, both loop
filters, their sharpness and deltas), then libwebp's fancy upsampler and
fixed-point colour conversion.

There is no numpy twin here, unlike the PNG and JPEG decoders: a Python
VP8 boolean decoder would take seconds a file and be a second decoder to
keep equal.  The reference is Pillow itself: the tests hold every case to
Pillow's pixels, and the card's run holds the committed fixtures to the
sha256 of Pillow's pixels recorded in ``tests/data/inputs/inputs.json``.
A library that cannot be built raises; nothing falls back to another
reader.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct

import numpy as np

from .errors import UnsupportedImageError

# VP8X flags
_ANIMATION, _ALPHA = 0x02, 0x10


@dataclasses.dataclass
class WebP:
    """A still WebP's size, Pillow's mode and its image chunk's payload."""

    width: int
    height: int
    lossless: bool
    mode: str
    bitstream: bytes


def _frame_size(kind: bytes, body: bytes):
    """(width, height, alpha bit) of a ``VP8 `` or ``VP8L`` payload."""
    if kind == b"VP8L":
        if len(body) < 5 or body[0] != 0x2F:
            raise ValueError("VP8L signature is missing")
        bits = struct.unpack("<I", body[1:5])[0]
        if bits >> 29:
            raise ValueError(f"VP8L version {bits >> 29} is not 0")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)
    if len(body) < 10:
        raise ValueError("VP8 frame header is truncated")
    tag = body[0] | body[1] << 8 | body[2] << 16
    if tag & 1:
        raise ValueError("VP8 frame is not a key frame")
    if body[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 start code is missing")
    w, h = struct.unpack("<HH", body[6:10])
    if not (w & 0x3FFF and h & 0x3FFF):
        raise ValueError("VP8 size is 0")
    return w & 0x3FFF, h & 0x3FFF, False


def parse(data: bytes) -> WebP:
    """The size, mode and image chunk of a still WebP file; raises
    ``UnsupportedImageError`` on an animated one and ``ValueError`` on a
    broken one."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file (no RIFF/WEBP header)")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 12:
        raise ValueError(f"WebP RIFF size {riff} is too small")
    if riff + 8 > len(data):
        raise ValueError(f"WebP file is truncated ({len(data)} of {riff + 8} bytes)")
    data = data[:riff + 8]
    canvas, alpha_chunk, flags, pos = None, False, 0, 12
    while True:
        if pos + 8 > len(data):
            raise ValueError("WebP file has no image chunk")
        kind, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ValueError(f"WebP chunk {kind!r} is truncated")
        if kind in (b"VP8 ", b"VP8L"):
            break
        if kind in (b"ANIM", b"ANMF"):
            raise UnsupportedImageError("animated WebP images are not supported (still images "
                                        "only)")
        if pos == 12:
            if kind != b"VP8X":
                raise ValueError(f"WebP file starts with a {kind!r} chunk")
            if size < 10:
                raise ValueError(f"WebP VP8X chunk of {size} bytes")
            flags = body[0]
            if flags & _ANIMATION:
                raise UnsupportedImageError("animated WebP images are not supported (still "
                                            "images only)")
            canvas = (1 + int.from_bytes(body[4:7], "little"),
                      1 + int.from_bytes(body[7:10], "little"))
        elif kind == b"VP8X":
            raise ValueError("WebP file holds a second VP8X chunk")
        alpha_chunk |= kind == b"ALPH"
        pos += 8 + size + (size & 1)
    lossless = kind == b"VP8L"
    w, h, alpha_bit = _frame_size(kind, body)
    if canvas is not None and canvas != (w, h):
        raise ValueError(f"WebP canvas {canvas[0]}x{canvas[1]} is not the {w}x{h} frame")
    alpha = (alpha_bit if lossless else bool(flags & _ALPHA)) or alpha_chunk
    return WebP(w, h, lossless, "RGBA" if alpha else "RGB", body)


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_webp

    lib = ctypes.CDLL(str(build_webp()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.icat_webp_decode.restype = ctypes.c_int
    lib.icat_webp_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     u8p, ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_webp_native(webp: WebP) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a parsed WebP, by ``csrc/webp.cc``."""
    stream = np.frombuffer(webp.bitstream or b"\0", np.uint8)
    out = np.empty((webp.height, webp.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = _native().icat_webp_decode(stream.ctypes.data_as(u8), len(webp.bitstream),
                                    int(webp.lossless), webp.width, webp.height,
                                    out.ctypes.data_as(u8), err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    return out


def decode_native(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a still WebP file, as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder.  Raises what
    ``parse`` raises, ``ValueError`` on a broken bitstream and
    ``RuntimeError`` where the decoder cannot be built."""
    return decode_webp_native(parse(data))
