"""TIFF in host C++, without PIL: the first image of a TIFF file as
Pillow's ``Image.open(path).convert("RGB")`` gives it, and the mode Pillow
opens it as.

``parse`` reads the header (``II`` or ``MM``; classic TIFF or BigTIFF) and
the first IFD, as Pillow opens page 0: the size, the strips or tiles and
their byte counts, the compression, the predictor, the planar
configuration, the colour map and the orientation, and the key Pillow's
``TiffImagePlugin`` looks its mode up by (byte order, photometric
interpretation, sample format, fill order, bits of each sample, extra
samples).  ``OPEN_INFO`` holds the rows of Pillow's table that this
reader decodes: photometric 0 and 1 (gray, 1, 2, 4, 8 and 16 bits, gray
with alpha), 2 (RGB and RGBA at 8 and 16 bits, the alpha unassociated,
premultiplied or unspecified), 3 (palette, 1 to 8 bits) and 5 (CMYK at
8 and 16 bits).  The rest of Pillow's rows (``PILLOW_ONLY``: 12-, 32-bit
and float gray, YCbCr, CIELab) raise ``UnsupportedImageError`` naming the
key, as do the compressions left out (CCITT, JPEG, ...) and planar files
of other than 8-bit samples; a key Pillow has no row for raises
``ValueError``, as Pillow does.

``decode_native`` hands the strips or tiles to the host C++ decoder
(``csrc/tiff.cc``, built with g++ on first use) for none, PackBits and
LZW; Deflate (Adobe's and the old code) is inflated here with CPython's
zlib first, as ``io/png.py`` inflates PNG data.  The decoder undoes
horizontal differencing, unpacks the samples and puts the chunks
together; here they become Pillow's RGB of the mode: ``1`` and ``L``
scaled to 8 bits (inverted for WhiteIsZero), ``I;16`` clipped to 255,
16-bit RGB(A) and CMYK their high bytes, premultiplied RGBA divided by
its alpha (Pillow's ``RGBa`` unpacker), a palette through the colour map's
high bytes (black past its end), CMYK through Pillow's ``cmyk2rgb``; then
the EXIF orientation is undone, as Pillow's ``exif_transpose`` does.

A broken file raises ``ValueError``.  There is no numpy twin; Pillow is
the reference (the tests hold every case to its pixels, and the card's
run holds the committed fixtures to their recorded sha256).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .errors import UnsupportedImageError, check_size
from .jpeg import cmyk_to_rgb

II, MM = b"II", b"MM"

# the rows of Pillow 12.1's TiffImagePlugin.OPEN_INFO this reader decodes:
# (byte order, photometric, sample format, fill order, bits a sample, extra
# samples) -> (mode, raw mode)
OPEN_INFO: Dict[tuple, Tuple[str, str]] = {}
for _o in (II, MM):
    for _fill in (1, 2):
        _r = "R" if _fill == 2 else ""
        OPEN_INFO.update({
            (_o, 0, (1,), _fill, (1,), ()): ("1", "1;I" + _r),
            (_o, 1, (1,), _fill, (1,), ()): ("1", "1" + (";R" if _r else "")),
            (_o, 0, (1,), _fill, (2,), ()): ("L", "L;2I" + _r),
            (_o, 1, (1,), _fill, (2,), ()): ("L", "L;2" + _r),
            (_o, 0, (1,), _fill, (4,), ()): ("L", "L;4I" + _r),
            (_o, 1, (1,), _fill, (4,), ()): ("L", "L;4" + _r),
            (_o, 0, (1,), _fill, (8,), ()): ("L", "L;I" + _r),
            (_o, 1, (1,), _fill, (8,), ()): ("L", "L" + (";R" if _r else "")),
            (_o, 2, (1,), _fill, (8, 8, 8), ()): ("RGB", "RGB" + (";R" if _r else "")),
            (_o, 3, (1,), _fill, (1,), ()): ("P", "P;1" + _r),
            (_o, 3, (1,), _fill, (2,), ()): ("P", "P;2" + _r),
            (_o, 3, (1,), _fill, (4,), ()): ("P", "P;4" + _r),
        })
    OPEN_INFO.update({
        (_o, 1, (2,), 1, (8,), ()): ("L", "L"),
        (_o, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
        (_o, 2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
        (_o, 2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
        (_o, 2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
        (_o, 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16"),
        (_o, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
        (_o, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
        (_o, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
        (_o, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
        (_o, 3, (1,), 1, (8,), ()): ("P", "P"),
        (_o, 3, (1,), 2, (8,), ()): ("P", "P;R"),
        (_o, 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
        (_o, 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
        (_o, 5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (_o, 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
        (_o, 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
        (_o, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    })
OPEN_INFO.update({
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
})
# the rows of Pillow's table left out here: 12-bit, signed, 32-bit and
# floating-point gray, bit-reversed 16-bit gray, YCbCr and CIELab
PILLOW_ONLY = {(o, p, f, fill, b, ()) for o in (II, MM) for p, f, fill, b in (
    (0, (3,), 1, (32,)), (1, (2,), 1, (16,)), (1, (2,), 1, (32,)), (1, (3,), 1, (32,)),
    (6, (1,), 1, (8,)), (6, (1,), 1, (8, 8, 8)), (8, (1,), 1, (8, 8, 8)))} | {
    (II, 1, (1,), 1, (12,), ()), (II, 1, (1,), 2, (16,), ()), (II, 1, (1,), 1, (32,), ())}
# the raw modes of planar files Pillow reads: uncompressed ones through its
# own band unpackers, compressed ones through libtiff's
_PLANAR_RAW = {"RGB", "RGB;R", "RGBA", "CMYK"}
_PLANAR_LIBTIFF = {"RGB", "RGB;R", "RGBA", "RGBa", "CMYK", "LA", "PA"}
# the fill order 2 raw modes Pillow's own reader has no unpacker for
_NO_RAW_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}
_COMPRESSIONS = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW",
                 6: "old-style JPEG", 7: "JPEG", 8: "Adobe Deflate", 32773: "PackBits",
                 32946: "Deflate", 32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24",
                 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_DECODED = (1, 5, 8, 32773, 32946)
# field types -> struct code
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# Pillow's largest samples a pixel (its table's longest key)
_MAX_SAMPLES = 6
# the largest strip or tile this reader decompresses
_MAX_CHUNK = 1 << 30


@dataclasses.dataclass
class Tiff:
    """What the decoder needs of a TIFF's first image."""

    width: int
    height: int
    mode: str
    raw: str  # Pillow's raw mode, which names the sample layout
    photometric: int
    bits: int
    samples: int
    compression: int
    predictor: int
    planar: int
    tiled: bool
    chunk_w: int
    chunk_h: int
    chunks: List[bytes]  # each strip or tile as stored (fill order 2: bits reversed)
    big_endian: bool
    colormap: Optional[np.ndarray]
    orientation: int


def _ifd(data: bytes) -> Tuple[bytes, Dict[int, tuple]]:
    """The byte order and the first IFD's {tag: values}."""
    if len(data) < 8 or data[:2] not in (II, MM):
        raise ValueError("not a TIFF file (no II or MM byte order)")
    order = "<" if data[:2] == II else ">"
    magic = struct.unpack_from(order + "H", data, 2)[0]
    if magic == 42:
        at, count_fmt, entry, inline, link = struct.unpack_from(order + "I", data, 4)[0], "H", 12, 4, "I"
    elif magic == 43:
        if order == ">":
            raise ValueError("big-endian BigTIFF: Pillow does not open it")
        if len(data) < 16 or struct.unpack_from(order + "HH", data, 4) != (8, 0):
            raise ValueError("BigTIFF header is not valid")
        at, count_fmt, entry, inline, link = struct.unpack_from(order + "Q", data, 8)[0], "Q", 20, 8, "Q"
    else:
        raise ValueError(f"TIFF header: magic number {magic} is neither 42 nor 43")
    n_size = struct.calcsize(count_fmt)
    if at + n_size > len(data):
        raise ValueError("TIFF file is truncated before its first IFD")
    n = struct.unpack_from(order + count_fmt, data, at)[0]
    if at + n_size + n * entry > len(data):
        raise ValueError("TIFF IFD is truncated")
    tags = {}
    for i in range(n):
        pos = at + n_size + i * entry
        tag, typ = struct.unpack_from(order + "HH", data, pos)
        count = struct.unpack_from(order + ("Q" if inline == 8 else "I"), data, pos + 4)[0]
        if typ not in _TYPES:
            continue  # Pillow skips a field of an unknown type
        code = _TYPES[typ]
        size = struct.calcsize(order + code) * count
        if size <= inline:
            where = pos + 4 + struct.calcsize(count_fmt if inline == 8 else "I")
        else:
            where = struct.unpack_from(order + link, data, pos + 4 + (8 if inline == 8 else 4))[0]
            if where + size > len(data):
                raise ValueError(f"TIFF field {tag} lies past the end of the file")
        if typ in (2, 7):
            tags[tag] = (data[where:where + count],)
        else:
            vals = struct.unpack_from(order + code * count, data, where)
            tags[tag] = tuple(vals[i:i + 2] for i in range(0, len(vals), 2)) if len(code) == 2 \
                else vals
    return data[:2], tags


def _int(tags, tag: int, default=None):
    vals = tags.get(tag)
    if vals is None:
        if default is None:
            raise ValueError(f"TIFF field {tag} is missing")
        return default
    if len(vals) != 1 or not isinstance(vals[0], int):
        raise ValueError(f"TIFF field {tag} is not one integer")
    return vals[0]


def _ints(tags, tag: int, default=None) -> tuple:
    vals = tags.get(tag, default)
    if vals is None:
        raise ValueError(f"TIFF field {tag} is missing")
    if not all(isinstance(v, int) for v in vals):
        raise ValueError(f"TIFF field {tag} is not integers")
    return tuple(vals)


# a byte's bits reversed (FillOrder 2)
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def parse(data: bytes) -> Tiff:
    """The mode, layout and strips or tiles of a TIFF's first image;
    raises ``UnsupportedImageError`` on a kind this reader leaves out and
    ``ValueError`` on a broken file."""
    order, tags = _ifd(data)
    compression = _int(tags, 259, 1)
    if compression not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not one Pillow knows")
    if compression not in _DECODED:
        raise UnsupportedImageError(f"{_COMPRESSIONS[compression]} TIFFs are not supported "
                                    "(none, LZW, Deflate and PackBits only)")
    w, h = _int(tags, 256), _int(tags, 257)
    check_size("TIFF", w, h)
    photometric = _int(tags, 262, 0)
    fill = _int(tags, 266, 1)
    fmt = _ints(tags, 339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = _ints(tags, 258, (1,))
    extra = _ints(tags, 338, ())
    spp = _int(tags, 277, 1)
    if spp > _MAX_SAMPLES:
        raise ValueError(f"TIFF of {spp} samples a pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"TIFF of {spp} samples a pixel but {len(bps)} bit counts")
    key = (order, photometric, fmt, fill, bps, extra)
    if key not in OPEN_INFO:
        what = (f"byte order {order.decode()}, photometric interpretation {photometric}, sample "
                f"format {fmt}, fill order {fill}, bits {bps} and extra samples {extra}")
        if key in PILLOW_ONLY:
            raise UnsupportedImageError(f"TIFFs of {what} are not supported")
        raise ValueError(f"TIFF of {what}: not a pixel layout Pillow reads")
    mode, raw = OPEN_INFO[key]
    planar = _int(tags, 284, 1)
    predictor = _int(tags, 317, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    planar = planar if spp > 1 else 1
    if planar == 2:
        if bps[0] != 8:
            raise UnsupportedImageError(f"planar TIFFs of {bps[0]}-bit samples are not supported "
                                        "(8-bit only)")
        if raw not in (_PLANAR_RAW if compression == 1 else _PLANAR_LIBTIFF):
            raise ValueError(f"planar TIFF of raw mode {raw}: Pillow has no band unpackers for it")
        if compression != 1 and raw == "RGBA" and not extra:
            raise UnsupportedImageError("compressed planar RGBA TIFFs without ExtraSamples are "
                                        "not supported (libtiff gives Pillow them premultiplied)")
    if compression == 1 and raw in _NO_RAW_UNPACKER:
        raise ValueError(f"uncompressed TIFF of raw mode {raw}: Pillow has no unpacker for it")
    if compression in (5, 8, 32946) and predictor != 1:
        if predictor != 2 or bps[0] not in (8, 16):
            raise ValueError(f"TIFF predictor {predictor} on {bps[0]}-bit integer samples")
    else:
        predictor = 1
    tiled = 322 in tags or 324 in tags
    if tiled:
        cw, ch = _int(tags, 322), _int(tags, 323)
        offsets, counts = _ints(tags, 324), _ints(tags, 325, ())
    else:
        cw, ch = w, min(_int(tags, 278, h), h) or h
        offsets, counts = _ints(tags, 273), _ints(tags, 279, ())
    if cw <= 0 or ch <= 0:
        raise ValueError(f"TIFF strips or tiles of {cw}x{ch}")
    per = 1 if planar == 2 else spp
    row_bytes = -(-cw * per * bps[0] // 8)
    if row_bytes * ch > _MAX_CHUNK:
        raise ValueError(f"TIFF strips or tiles of {cw}x{ch} pixels are too large")
    planes = spp if planar == 2 else 1
    across, down = (-(-w // cw) if tiled else 1), -(-h // ch)
    need = across * down * planes
    if len(offsets) < need:
        raise ValueError(f"TIFF has {len(offsets)} strips or tiles where its image needs {need}")
    if compression != 1 and len(counts) < need:
        raise ValueError("TIFF has no byte count for each strip or tile")
    chunks = []
    for i in range(need):
        y0 = (i % (across * down)) // across * ch
        rows = ch if tiled else min(ch, h - y0)
        size = row_bytes * rows
        start = offsets[i]
        if compression == 1:  # read as Pillow's raw reader: the rows it needs, from the offset
            visible = row_bytes * min(rows, h - y0)
            if start + visible > len(data):
                raise ValueError("TIFF image data is truncated")
            chunk = data[start:start + visible]
        else:
            end = start + counts[i]
            if end > len(data):
                raise ValueError("TIFF strip or tile is truncated")
            chunk = data[start:end]
        if fill == 2:
            chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        if compression in (8, 32946):
            try:
                chunk = zlib.decompressobj().decompress(chunk, size)
            except zlib.error as e:
                raise ValueError(f"TIFF Deflate data is corrupt: {e}") from None
            if len(chunk) < size:
                raise ValueError("TIFF Deflate data ends before its strip or tile does")
        if compression in (1, 8, 32946):
            chunk = chunk.ljust(size, b"\0")
        chunks.append(chunk)
    colormap = None
    if photometric == 3:
        cmap = _ints(tags, 320, ())
        if not cmap:
            raise ValueError("palette TIFF has no colour map")
        n = len(cmap) // 3
        colormap = np.zeros((256, 3), np.uint8)
        take = min(n, 256)
        cm = np.array(cmap[:3 * n], np.int64).reshape(3, n)[:, :take] // 256
        colormap[:take] = cm.T
    return Tiff(w, h, mode, raw, photometric, bps[0], spp,
                1 if compression in (8, 32946) else compression, predictor, planar, tiled, cw, ch,
                chunks, order == MM, colormap, _int(tags, 274, 1))


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_tiff

    lib = ctypes.CDLL(str(build_tiff()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.icat_tiff_decode.restype = ctypes.c_int
    lib.icat_tiff_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64p, i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_char_p, ctypes.c_int]
    return lib


def decode_samples(t: Tiff) -> np.ndarray:
    """(H, W, samples) uint16 samples of a parsed TIFF, by ``csrc/tiff.cc``."""
    joined = b"".join(t.chunks)
    lengths = np.array([len(c) for c in t.chunks], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    buf = np.frombuffer(joined or b"\0", np.uint8)
    out = np.empty((t.height, t.width, t.samples), np.uint16)
    err = ctypes.create_string_buffer(256)
    rc = _native().icat_tiff_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(joined), len(t.chunks),
        t.compression, t.width, t.height, t.chunk_w, t.chunk_h, int(t.tiled), t.planar, t.samples,
        t.bits, t.predictor, int(t.big_endian), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    return out


def _gray(v: np.ndarray) -> np.ndarray:
    return np.repeat(v.astype(np.uint8)[..., None], 3, -1)


def to_rgb(t: Tiff, s: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's ``convert("RGB")`` of the mode ``t`` opens
    as, from its (H, W, samples) samples."""
    if t.mode in ("1", "L", "LA"):
        v = s[..., 0].astype(np.int64)
        v = v * 255 // ((1 << t.bits) - 1) if t.bits < 8 else v
        return _gray(255 - v if t.photometric == 0 else v)
    if t.mode in ("I;16", "I;16B"):
        return _gray(np.minimum(s[..., 0], 255))
    if t.mode in ("P", "PA"):
        return t.colormap[s[..., 0]]
    hi = (s >> 8 if t.bits == 16 else s).astype(np.int64)
    if t.mode == "CMYK":
        return cmyk_to_rgb(255 - hi[..., :4])
    rgb = hi[..., :3]
    if t.raw.startswith("RGBa"):  # premultiplied: Pillow's unpacker divides by alpha
        a = hi[..., 3:4]
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb,
                                           np.minimum(rgb * 255 // np.maximum(a, 1), 255)))
    return rgb.astype(np.uint8)


# EXIF orientation -> Pillow's exif_transpose, as numpy on (H, W, C)
_ORIENT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
    7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1),
}


def decode_tiff_native(t: Tiff) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a parsed TIFF, orientation undone."""
    rgb = to_rgb(t, decode_samples(t))
    return np.ascontiguousarray(_ORIENT.get(t.orientation, lambda a: a)(rgb))


def decode_native(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a TIFF file's first image, as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder.  Raises what
    ``parse`` raises, ``ValueError`` on broken strips and ``RuntimeError``
    where the decoder cannot be built."""
    return decode_tiff_native(parse(data))
