"""WebP in host C++, without PIL: a WebP's pixels (an animated one's first
frame) as Pillow's ``Image.open(path).convert("RGB")`` gives them.

``parse`` walks the RIFF container: its size field (bytes past it are
ignored, a file shorter than it is truncated), each chunk's size and its
padding to an even length, ``VP8X`` (the canvas size and the alpha and
animation flags) and the image chunk, ``VP8 `` (lossy) or ``VP8L``
(lossless), whose header it reads for the size.  ``ALPH``, ``ICCP``,
``EXIF``, ``XMP `` and unknown chunks are skipped: Pillow's RGB does not
depend on them (libwebp decodes unpremultiplied RGBA, so its colour does
not depend on alpha).  Of an animated file (the ``VP8X`` animation flag,
``ANIM``, then ``ANMF`` chunks) it reads the first ``ANMF``: its offset and
the ``ALPH`` and ``VP8 `` or ``VP8L`` sub-chunks inside, whose bitstream
gives the frame's size, as libwebp's demuxer does; the frame is decoded
into a zero-filled canvas of the ``VP8X`` size, as ``anim_decode.c``
decodes a key frame; later frames are walked for their headers and
bounds alone, which the demuxer checks.  A broken container
raises ``ValueError``.  The mode is Pillow's: of an animated file
``RGBA`` where the ``VP8X`` alpha flag is set; of a still one ``RGBA`` where
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
from typing import Iterator, Optional, Tuple

import numpy as np

# VP8X flags
_ANIMATION, _ALPHA = 0x02, 0x10


@dataclasses.dataclass
class WebP:
    """A WebP's frame size, Pillow's mode and its image chunk's payload;
    for an animated file, the first frame's offset on the canvas, whose
    size ``canvas`` is (width, height)."""

    width: int
    height: int
    lossless: bool
    mode: str
    bitstream: bytes
    canvas: Optional[Tuple[int, int]] = None
    offset: Tuple[int, int] = (0, 0)


def _frame_size(kind: bytes, body: bytes):
    """(width, height, alpha bit) of a ``VP8 `` or ``VP8L`` payload, whose
    header is checked as libwebp's ``VP8GetInfo`` and ``VP8LGetInfo`` do."""
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
    if (tag >> 1) & 7 > 3 or not (tag >> 4) & 1 or tag >> 5 >= len(body):
        raise ValueError("VP8 frame tag: a profile past 3, a hidden frame or a first partition "
                         "past the chunk")
    if body[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8 start code is missing")
    w, h = struct.unpack("<HH", body[6:10])
    if not (w & 0x3FFF and h & 0x3FFF):
        raise ValueError("VP8 size is 0")
    return w & 0x3FFF, h & 0x3FFF, False


def _chunks(data: bytes, pos: int, end: int) -> Iterator[Tuple[bytes, bytes, int]]:
    """(type, payload, offset) of each chunk in data[pos:end], each padded
    to an even length; raises on one the data cuts short."""
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if pos + 8 + size > end:
            raise ValueError(f"WebP chunk {kind!r} is truncated")
        yield kind, body, pos
        pos += 8 + size + (size & 1)


def _anim_frame(anmf: bytes, canvas: Tuple[int, int], alpha_flag: bool) -> WebP:
    """An ``ANMF`` chunk's frame: its offset (twice the stored values), and
    its ``ALPH`` and ``VP8 `` or ``VP8L`` sub-chunks, whose bitstream gives
    the frame's size, as libwebp's demuxer takes it; raises on a frame the
    demuxer refuses."""
    if len(anmf) < 16:
        raise ValueError("WebP ANMF chunk is truncated")
    x, y = 2 * int.from_bytes(anmf[0:3], "little"), 2 * int.from_bytes(anmf[3:6], "little")
    alph = False
    for kind, body, _ in _chunks(anmf, 16, len(anmf)):
        if kind == b"ALPH" and not alph:
            alph = True
            continue
        if kind not in (b"VP8 ", b"VP8L"):
            break
        if kind == b"VP8L" and alph:
            raise ValueError("WebP frame holds both ALPH and VP8L")
        w, h, _ = _frame_size(kind, body)
        if x + w > canvas[0] or y + h > canvas[1]:
            raise ValueError(f"WebP frame of {w}x{h} at ({x}, {y}) lies past the "
                             f"{canvas[0]}x{canvas[1]} canvas")
        return WebP(w, h, kind == b"VP8L", "RGBA" if alpha_flag else "RGB", body, canvas, (x, y))
    raise ValueError("WebP ANMF chunk holds no image")


def parse(data: bytes) -> WebP:
    """The size, mode and image chunk of a WebP file (of an animated one,
    its first frame's, and the canvas); raises ``ValueError`` on a broken
    one."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file (no RIFF/WEBP header)")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff < 12:
        raise ValueError(f"WebP RIFF size {riff} is too small")
    if riff + 8 > len(data):
        raise ValueError(f"WebP file is truncated ({len(data)} of {riff + 8} bytes)")
    canvas, alpha_chunk, flags, anim, first = None, False, 0, False, None
    for kind, body, pos in _chunks(data, 12, riff + 8):
        if pos == 12:
            if kind in (b"VP8 ", b"VP8L"):
                w, h, alpha_bit = _frame_size(kind, body)
                return WebP(w, h, kind == b"VP8L", "RGBA" if alpha_bit else "RGB", body)
            if kind != b"VP8X":
                raise ValueError(f"WebP file starts with a {kind!r} chunk")
            if len(body) < 10:
                raise ValueError(f"WebP VP8X chunk of {len(body)} bytes")
            flags = body[0]
            canvas = (1 + int.from_bytes(body[4:7], "little"),
                      1 + int.from_bytes(body[7:10], "little"))
            continue
        if kind == b"VP8X":
            raise ValueError("WebP file holds a second VP8X chunk")
        if kind == b"ANIM":
            if len(body) < 6:
                raise ValueError("WebP ANIM chunk is truncated")
            anim = True
        elif kind == b"ANMF":
            if not anim:
                raise ValueError("WebP ANMF chunk before its ANIM chunk")
            if not flags & _ANIMATION:
                raise ValueError("WebP ANMF chunk without the VP8X animation flag")
            frame = _anim_frame(body, canvas, bool(flags & _ALPHA))  # later ones: checked
            first = first or frame
        elif kind in (b"VP8 ", b"VP8L"):
            if first or anim or flags & _ANIMATION:
                raise ValueError("WebP animation whose image lies outside an ANMF chunk")
            w, h, alpha_bit = _frame_size(kind, body)
            if canvas != (w, h):
                raise ValueError(f"WebP canvas {canvas[0]}x{canvas[1]} is not the {w}x{h} "
                                 "frame")
            lossless = kind == b"VP8L"
            alpha = (alpha_bit if lossless else bool(flags & _ALPHA)) or alpha_chunk
            return WebP(w, h, lossless, "RGBA" if alpha else "RGB", body)
        alpha_chunk |= kind == b"ALPH"
    if first:
        return first
    raise ValueError("WebP file has no image chunk" + (" (an animation of no frame)" if anim
                                                       else ""))


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
    """(H, W, 3) uint8 RGB pixels of a parsed WebP, by ``csrc/webp.cc``;
    of an animated one, its canvas after the first frame, decoded into a
    zero-filled canvas as libwebp's ``anim_decode.c`` decodes a key frame
    (no blending)."""
    stream = np.frombuffer(webp.bitstream or b"\0", np.uint8)
    out = np.empty((webp.height, webp.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    rc = _native().icat_webp_decode(stream.ctypes.data_as(u8), len(webp.bitstream),
                                    int(webp.lossless), webp.width, webp.height,
                                    out.ctypes.data_as(u8), err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    if webp.canvas is None:
        return out
    canvas = np.zeros((webp.canvas[1], webp.canvas[0], 3), np.uint8)
    x, y = webp.offset
    canvas[y:y + webp.height, x:x + webp.width] = out
    return canvas


def decode_native(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a WebP file (an animated one's first
    frame on its canvas), as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder.  Raises what
    ``parse`` raises, ``ValueError`` on a broken bitstream and
    ``RuntimeError`` where the decoder cannot be built."""
    return decode_webp_native(parse(data))
