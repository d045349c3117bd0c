"""Netpbm in numpy, without PIL: the kinds Pillow's ``PpmImagePlugin``
opens, the samples it holds for each, the mode it opens it as and its
``convert("RGB")``.

* P1 and P4 (bitmaps) open as ``1``: a 1 bit or ``'1'`` is black.  The raw
  form packs 8 pixels a byte, rows padded to whole bytes; the plain form
  takes every non-space byte as a pixel, and any byte but ``'0'`` or
  ``'1'`` raises.
* P2 and P5 (gray) open as ``L`` with a maxval up to 255, else as ``I``;
  P3 and P6 (colour) open as ``RGB`` at any maxval.  A sample ``v`` becomes
  ``round(v / maxval * out)``, with ``out`` 255 (``L``, ``RGB``) or 65535
  (``I``): Python's ``round``, half to even, of the same float64 division.
  The raw forms read one byte a sample below maxval 256 and two (big-
  endian) above, clip at ``out`` and take maxval 255 (and 65535 for gray)
  as they are.  The plain forms read decimal tokens, raise on one longer
  than 10 bytes, negative, or past maxval.
* ``Pf`` (gray PFM) opens as ``F``: float32 rows bottom to top, little-
  endian where the scale is negative.
* The header is Pillow's: a magic of up to 6 bytes ended by whitespace,
  then tokens ended by one whitespace byte each, ``#`` dropping the rest of
  its line (a token may run on after it); maxval must lie in 1..65535.  In
  the plain forms a comment runs to CR or LF and takes that byte with it.

Pillow raises on PAM (P7) and colour PFM (``PF``), and so does this
reader, with ``UnsupportedImageError`` naming the kind.  Pillow's own
test extensions (``P0CMYK``, ``PyP``, ``PyRGBA``, ``PyCMYK``: CMYK,
palette and RGBA samples under a Netpbm header, which no Netpbm tool
writes) it opens, and this reader refuses, naming them.  A file short of
its samples raises ``ValueError``, as Pillow's "image file is truncated"
does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .errors import RefusedByPillowError, UnsupportedImageError, check_size

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"Pf": "F"}
# what Pillow raises on, and the extensions it opens for its own tests
_REFUSED = {b"P7": "a PAM (P7) file: Pillow does not open it, nor does the port's Netpbm "
                   "reader",
            b"PF": "a colour PFM (PF) file: Pillow does not open it, nor does the port's "
                   "Netpbm reader"}
_EXTENSIONS = {b"P0CMYK": "CMYK", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_MAX_TOKEN = 10


def is_netpbm(data: bytes) -> bool:
    """Whether ``data`` starts as a Netpbm file Pillow would try: ``P``
    then one of ``0123456fy``, or ``P7``/``PF``, which it refuses."""
    return len(data) >= 2 and data[:1] == b"P" and data[1:2] in (b"0", b"1", b"2", b"3", b"4",
                                                                 b"5", b"6", b"7", b"f", b"F",
                                                                 b"y")


@dataclasses.dataclass
class Netpbm:
    """A parsed file: Pillow's mode, the size and the samples it holds:
    (H, W) uint8 for ``1`` (0 or 255) and ``L``, (H, W, 3) uint8 for
    ``RGB``, (H, W) int32 for ``I`` and float32 for ``F``."""

    magic: bytes
    mode: str
    width: int
    height: int
    samples: np.ndarray


class _Header:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.byte()
            if not c or c in _WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= _MAX_TOKEN:
            c = self.byte()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.byte() not in b"\r\n":  # an empty read ends it too
                    pass
                continue
            token += c
        if not token:
            raise ValueError("Netpbm: reached the end of the file while reading the header")
        if len(token) > _MAX_TOKEN:
            raise ValueError(f"Netpbm: header token too long: {token!r}")
        return token


def _plain_body(body: bytes) -> bytes:
    """The plain body without its comments: each ``#`` to the first CR or
    LF after it, that byte included (Pillow's ``PpmPlainDecoder``)."""
    out, pos = [], 0
    while True:
        start = body.find(b"#", pos)
        if start < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:start])
        ends = [e for e in (body.find(b"\n", start), body.find(b"\r", start)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _short(magic: bytes) -> ValueError:
    return ValueError(f"Netpbm {magic.decode()}: not enough image data")


def parse(data: bytes) -> Netpbm:
    """Read a Netpbm file as Pillow opens and loads it."""
    head = _Header(data)
    magic = head.magic()
    if magic in _REFUSED:
        raise RefusedByPillowError(_REFUSED[magic])
    if magic in _EXTENSIONS:
        raise UnsupportedImageError(f"Pillow's test extension {magic.decode()} (no Netpbm kind): "
                                    f"Pillow opens it as {_EXTENSIONS[magic]}, the port's Netpbm "
                                    "reader does not")
    if magic not in _MODES:
        raise ValueError(f"not a Netpbm file (magic {magic!r})")
    mode = _MODES[magic]
    w, h = int(head.token()), int(head.token())
    check_size("Netpbm", w, h)
    if mode == "F":
        scale = float(head.token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("Netpbm Pf: scale must be finite and non-zero")
        n = w * h * 4
        body = data[head.pos:head.pos + n]
        if len(body) < n:
            raise _short(magic)
        order = "<" if scale < 0 else ">"
        v = np.frombuffer(body, order + "f4").reshape(h, w)[::-1]
        return Netpbm(magic, mode, w, h, v.astype(np.float32))
    maxval = 1
    if mode != "1":
        maxval = int(head.token())
        if not 0 < maxval < 65536:
            raise ValueError("Netpbm: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    bands = 3 if mode == "RGB" else 1
    body = data[head.pos:]
    if magic in (b"P1", b"P2", b"P3"):
        samples = _plain(magic, mode, _plain_body(body), w * h * bands, maxval)
    else:
        samples = _raw(magic, mode, body, w, h, bands, maxval)
    shape = (h, w, 3) if bands == 3 else (h, w)
    return Netpbm(magic, mode, w, h, samples.reshape(shape))


def _plain(magic: bytes, mode: str, body: bytes, total: int, maxval: int) -> np.ndarray:
    if mode == "1":
        tokens = b"".join(body.split())[:total]
        bad = set(tokens) - {48, 49}
        if bad:
            raise ValueError(f"Netpbm P1: invalid token {bytes([min(bad)])!r}")
        if len(tokens) < total:
            raise _short(magic)
        return np.where(np.frombuffer(tokens, np.uint8) == 48, 255, 0).astype(np.uint8)
    out_max = 65535 if mode == "I" else 255
    values = []
    for token in body.split():
        if len(token) > _MAX_TOKEN:
            raise ValueError(f"Netpbm {magic.decode()}: token too long: {token[:11]!r}")
        v = int(token)
        if v < 0:
            raise ValueError(f"Netpbm {magic.decode()}: channel value is negative: {v}")
        if v > maxval:
            raise ValueError(f"Netpbm {magic.decode()}: channel value too large: {v}")
        values.append(v)
        if len(values) == total:
            break
    if len(values) < total:
        raise _short(magic)
    return _rescale(np.array(values, np.float64), maxval, out_max, mode)


def _rescale(v: np.ndarray, maxval: int, out_max: int, mode: str) -> np.ndarray:
    """``min(out_max, round(v / maxval * out_max))`` per sample."""
    scaled = np.minimum(np.round(v / maxval * out_max), out_max)
    return scaled.astype(np.int32 if mode == "I" else np.uint8)


def _raw(magic: bytes, mode: str, body: bytes, w: int, h: int, bands: int,
         maxval: int) -> np.ndarray:
    if mode == "1":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise _short(magic)
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride), axis=1)
        return np.where(bits[:, :w] == 0, 255, 0).astype(np.uint8)
    wide = maxval > 255
    n = w * h * bands
    raw = np.frombuffer(body[:n * (2 if wide else 1)], ">u2" if wide else np.uint8)
    if raw.size < n:
        raise _short(magic)
    if maxval == 255:
        return raw.copy()
    if maxval == 65535 and mode == "I":
        return raw.astype(np.int32)
    return _rescale(raw.astype(np.float64), maxval, 65535 if mode == "I" else 255, mode)


def to_rgb(p: Netpbm) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's ``convert("RGB")`` of the samples."""
    if p.mode == "RGB":
        return p.samples
    v = p.samples
    if p.mode == "I":  # i2rgb: clipped to 0..255
        v = np.clip(v, 0, 255)
    elif p.mode == "F":  # f2l: clipped, truncated, NaN as 0
        with np.errstate(invalid="ignore"):
            v = np.where(v <= 0, 0, np.where(v >= 255, 255, np.nan_to_num(v, nan=0.0)))
    return np.repeat(v.astype(np.uint8)[..., None], 3, -1)


def decode(data: bytes) -> Tuple[np.ndarray, str]:
    """(H, W, 3) uint8 pixels as Pillow's ``convert("RGB")`` gives them,
    and the mode Pillow opens the file as."""
    p = parse(data)
    return to_rgb(p), p.mode
