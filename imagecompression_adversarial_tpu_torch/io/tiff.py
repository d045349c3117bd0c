"""TIFF in host C++, without PIL: the first image of a TIFF file as
Pillow's ``Image.open(path).convert("RGB")`` gives it, and the mode Pillow
opens it as.

``parse`` reads the header (``II`` or ``MM``; classic TIFF or BigTIFF) and
the first IFD, as Pillow opens page 0: the size, the strips or tiles and
their byte counts, the compression, the predictor, the planar
configuration, the colour map, the orientation, the YCbCr fields and the
CCITT options, and the key Pillow's ``TiffImagePlugin`` looks its mode up
by (byte order, photometric interpretation, sample format, fill order,
bits of each sample, extra samples).  ``OPEN_INFO`` and ``WIDE_INFO``
hold the rows of Pillow's table that this reader decodes: photometric 0
and 1 (gray of 1, 2, 4, 8, 12, 16 and 32 bits, signed, unsigned and
floating-point, bit-reversed 16-bit gray, gray with alpha), 2 (RGB and
RGBA at 8 and 16 bits, the alpha unassociated, premultiplied or
unspecified), 3 (palette, 1 to 8 bits), 5 (CMYK at 8 and 16 bits), 6
(YCbCr) and 8 (CIELab).  The rest of Pillow's rows (``PILLOW_ONLY``:
one-sample YCbCr) raise ``UnsupportedImageError`` naming the key, as do
the compressions left out (old-style JPEG, ThunderScan, SGILog, WebP) and
planar files of other than 8-bit samples; a key Pillow has no row for
raises ``ValueError``, as Pillow does.

``decode_native`` hands the strips or tiles to the host C++ decoder
(``csrc/tiff.cc``, built with g++ on first use) for none, PackBits, LZW
and CCITT (RLE, Group 3 1-D and 2-D, Group 4); Deflate (Adobe's and the
old code), Zstandard (the system's libzstd, ``io/zstd.py``) and LZMA
(CPython's ``lzma``) are inflated here first, as ``io/png.py`` inflates
PNG data, and each JPEG strip or tile (compression 7) is decoded by the
host JPEG decoder (``io/jpeg.py``, ``csrc/jpeg.cc``) with the file's
``JPEGTables``, in the colour space libtiff gives it from the TIFF's
photometric interpretation: YCbCr to RGB after libjpeg's fancy
upsampling, RGB and gray as coded.  The decoder undoes horizontal
differencing and the floating-point predictor, unpacks the samples and
puts the chunks together; here they become Pillow's RGB of the mode:
``1`` and ``L`` scaled to 8 bits (inverted for WhiteIsZero), ``I;16``
clipped to 255, ``I`` (32-bit signed) clipped to 0..255, ``F`` clipped and
truncated (Pillow's ``i2rgb`` and ``f2l``), 16-bit RGB(A) and CMYK their
high bytes, premultiplied RGBA divided by its alpha (Pillow's ``RGBa``
unpacker), a palette through the colour map's high bytes (black past its
end), CMYK through Pillow's ``cmyk2rgb``, CIELab through LittleCMS's
Lab -> sRGB transform (``io/cielab.py``); YCbCr of the other compressions
through libtiff's RGBA reader, which Pillow takes for them (its
``TIFFYCbCrToRGB`` tables with the file's ``YCbCrCoefficients`` and
``ReferenceBlackWhite``, each data unit's chroma over its pixels; it
makes no flip of its own for the orientation, as Pillow calls it); then
the EXIF orientation is undone, as Pillow's ``exif_transpose`` does.

A broken file raises ``ValueError``.  There is no numpy twin of the
decoder but for CCITT, whose plain version is ``io/fax.py``; Pillow is the
reference (the tests hold every case to its pixels, and the card's run
holds the committed fixtures to their recorded sha256).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import lzma
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import cielab, fax, jpeg, zstd
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
# the rows of Pillow's table whose samples are 12, 32 or signed 16 bits,
# floating-point, bit-reversed 16-bit gray, YCbCr or CIELab
WIDE_INFO: Dict[tuple, Tuple[str, str]] = {
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
}
for _o, _b in ((II, ""), (MM, "B")):
    WIDE_INFO.update({
        (_o, 1, (2,), 1, (16,), ()): ("I", f"I;16{_b}S"),
        (_o, 1, (2,), 1, (32,), ()): ("I", f"I;32{_b}S"),
        (_o, 0, (3,), 1, (32,), ()): ("F", f"F;32{_b}F"),
        (_o, 1, (3,), 1, (32,), ()): ("F", f"F;32{_b}F"),
        (_o, 6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
        (_o, 8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
    })
# the rows of Pillow's table left out here: one-sample YCbCr
PILLOW_ONLY = {(o, 6, (1,), 1, (8,), ()) for o in (II, MM)}
# the raw modes whose samples libtiff hands Pillow in the machine's byte
# order and Pillow unpacks in the file's: a compressed big-endian file's
# values come out byte-swapped
_SWAPPED_RAW = {"I;16BS", "I;32BS", "F;32BF"}
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
_DECODED = (1, 2, 3, 4, 5, 7, 8, 32773, 32946, 34925, 50000)
_CCITT = (2, 3, 4)
# the compressions libtiff attaches its predictor to
_PREDICTED = (5, 8, 32946, 34925, 50000)
# libtiff's YCbCr sampling layouts (tif_getimage.c's putcontig8bitYCbCr*tile)
_YCBCR_SAMPLING = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
# libtiff's defaults of YCbCrCoefficients and ReferenceBlackWhite for 8 bits
_LUMA = (0.299, 0.587, 0.114)
_REF_BLACK_WHITE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
# field types -> struct code
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# Pillow's largest samples a pixel (its table's longest key)
_MAX_SAMPLES = 6
# the fields whose type libtiff's TIFFReadDirectory checks, failing on one
# it does not know (Pillow's own reader, for uncompressed files, skips them)
_LIBTIFF_TYPED = {256, 257, 258, 259, 277, 278, 284, 322, 323, 338, 339}
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
    jpeg_tables: bytes = b""  # compression 7: the JPEGTables stream
    ycbcr: Tuple[int, int] = (1, 1)  # YCbCr: luma samples a data unit across, down
    luma: Tuple[float, ...] = _LUMA  # YCbCrCoefficients
    ref_black_white: Tuple[float, ...] = _REF_BLACK_WHITE
    fax_options: int = 0  # T4Options of a Group 3 file
    rgba: bool = False  # YCbCr through libtiff's RGBA reader (every codec but none and JPEG)
    swapped: bool = False  # samples Pillow unpacks byte-swapped (_SWAPPED_RAW)


def _ifd(data: bytes) -> Tuple[bytes, Dict[int, tuple], set]:
    """The byte order, the first IFD's {tag: values}, and the tags of the
    fields skipped for a type Pillow does not know."""
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
    tags, skipped = {}, set()
    for i in range(n):
        pos = at + n_size + i * entry
        tag, typ = struct.unpack_from(order + "HH", data, pos)
        count = struct.unpack_from(order + ("Q" if inline == 8 else "I"), data, pos + 4)[0]
        if typ not in _TYPES:
            skipped.add(tag)  # Pillow skips a field of an unknown type
            continue
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
    return data[:2], tags, skipped


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


def _floats(tags, tag: int, default: Tuple[float, ...]) -> Tuple[float, ...]:
    """A RATIONAL field as libtiff reads it into floats (0 over 0 is 0)."""
    vals = tags.get(tag)
    if vals is None:
        return default
    if len(vals) != len(default) or not all(isinstance(v, tuple) for v in vals):
        raise ValueError(f"TIFF field {tag} is not {len(default)} rationals")
    return tuple(float(np.float32(n / d if d else 0.0)) for n, d in vals)


def _inflate(compression: int, chunk: bytes, size: int) -> bytes:
    """The first ``size`` bytes of a Deflate, Zstandard or LZMA chunk, as
    libtiff's decoders stop where the strip or tile is full."""
    name = _COMPRESSIONS[compression]
    try:
        if compression in (8, 32946):
            chunk = zlib.decompressobj().decompress(chunk, size)
        elif compression == 50000:
            chunk = zstd.decompress_prefix(chunk, size)
        else:
            chunk = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(chunk, size)
    except (zlib.error, lzma.LZMAError, ValueError) as e:
        raise ValueError(f"TIFF {name} data is corrupt: {e}") from None
    if len(chunk) < size:
        raise ValueError(f"TIFF {name} data ends before its strip or tile does")
    return chunk


def parse(data: bytes) -> Tiff:
    """The mode, layout and strips or tiles of a TIFF's first image;
    raises ``UnsupportedImageError`` on a kind this reader leaves out and
    ``ValueError`` on a broken file."""
    order, tags, skipped = _ifd(data)
    compression = _int(tags, 259, 1)
    if compression not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not one Pillow knows")
    if compression != 1 and skipped & _LIBTIFF_TYPED:
        raise ValueError(f"TIFF fields {sorted(skipped & _LIBTIFF_TYPED)} of a type libtiff does "
                         "not know: its TIFFReadDirectory fails on them")
    if compression not in _DECODED:
        raise UnsupportedImageError(f"{_COMPRESSIONS[compression]} TIFFs are not supported "
                                    "(none, CCITT, LZW, JPEG, Deflate, PackBits, LZMA and "
                                    "Zstandard only)")
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
    if key not in OPEN_INFO and key not in WIDE_INFO:
        what = (f"byte order {order.decode()}, photometric interpretation {photometric}, sample "
                f"format {fmt}, fill order {fill}, bits {bps} and extra samples {extra}")
        if key in PILLOW_ONLY:
            raise UnsupportedImageError(f"TIFFs of {what} are not supported")
        raise ValueError(f"TIFF of {what}: not a pixel layout Pillow reads")
    mode, raw = OPEN_INFO.get(key) or WIDE_INFO[key]
    planar = _int(tags, 284, 1)
    predictor = _int(tags, 317, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    planar = planar if spp > 1 else 1
    ycbcr = photometric == 6
    if planar == 2:
        if bps[0] != 8:
            raise UnsupportedImageError(f"planar TIFFs of {bps[0]}-bit samples are not supported "
                                        "(8-bit only)")
        if ycbcr:
            raise UnsupportedImageError("planar YCbCr TIFFs are not supported")
        if raw not in (_PLANAR_RAW if compression == 1 else _PLANAR_LIBTIFF):
            raise ValueError(f"planar TIFF of raw mode {raw}: Pillow has no band unpackers for it")
        if compression != 1 and raw == "RGBA" and not extra:
            raise UnsupportedImageError("compressed planar RGBA TIFFs without ExtraSamples are "
                                        "not supported (libtiff gives Pillow them premultiplied)")
    if compression == 1 and raw in _NO_RAW_UNPACKER:
        raise ValueError(f"uncompressed TIFF of raw mode {raw}: Pillow has no unpacker for it")
    if compression in _CCITT and bps != (1,):
        raise ValueError(f"{_COMPRESSIONS[compression]} TIFF of {bps}-bit samples: libtiff "
                         "decodes 1-bit samples only")
    if compression == 7 and (photometric not in (1, 2, 6) or bps[0] != 8 or extra):
        raise UnsupportedImageError(f"JPEG TIFFs of photometric interpretation {photometric}, "
                                    f"bits {bps} and extra samples {extra} are not supported "
                                    "(gray, RGB and YCbCr only)")
    if compression in _PREDICTED and predictor != 1:
        floating = predictor == 3 and fmt == (3,) and bps[0] == 32
        if not floating and (predictor != 2 or bps[0] not in (8, 16, 32)):
            raise ValueError(f"TIFF predictor {predictor} on {bps[0]}-bit samples of format {fmt}")
    else:
        predictor = 1
    sampling, luma, ref = (1, 1), _LUMA, _REF_BLACK_WHITE
    if ycbcr and compression == 7:
        # libtiff takes the sampling from the first chunk's frame where the
        # field is missing (JPEGFixupTagsSubsampling)
        sampling = tuple(_ints(tags, 530, ())) or None
    elif ycbcr:
        if compression == 1:
            # Pillow's raw reader takes its RGBX unpacker over the YCbCr
            # samples: four bytes a pixel, past the strip's three
            if 322 in tags or 324 in tags:
                raise UnsupportedImageError("uncompressed tiled YCbCr TIFFs are not supported")
            spp, bps = 4, (8,) * 4
        else:  # libtiff's RGBA reader, which Pillow takes for YCbCr
            sampling = _ints(tags, 530, (2, 2))
            if len(sampling) != 2 or tuple(sampling) not in _YCBCR_SAMPLING:
                raise ValueError(f"TIFF YCbCr subsampling {sampling}: libtiff's RGBA reader "
                                 "has no layout for it")
            sampling = tuple(sampling)
            luma = _floats(tags, 529, _LUMA)
            ref = _floats(tags, 532, _REF_BLACK_WHITE)
            if any(np.isnan(luma)) or abs(luma[1]) < 1e-7:
                raise ValueError(f"TIFF YCbCrCoefficients {luma} are not valid")
            if not all(-0x7FFFFFFF + 128 < v < 0x7FFFFFFF for v in ref):
                raise ValueError(f"TIFF ReferenceBlackWhite {ref} is not valid")
            if sampling != (1, 1) and predictor != 1:
                raise UnsupportedImageError("subsampled YCbCr TIFFs with a predictor are not "
                                            "supported")
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
    # libtiff's RGBA reader goes on past a fault in any strip but a first
    # one it cannot read, leaving Pillow the rows it had
    rgba = ycbcr and compression not in (1, 7)
    chunks = []
    for i in range(need):
        y0 = (i % (across * down)) // across * ch
        rows = ch if tiled else min(ch, h - y0)
        if rgba and sampling != (1, 1):
            size = -(-rows // sampling[1]) * -(-cw // sampling[0]) * (sampling[0] * sampling[1] + 2)
        else:
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
                if rgba and i:
                    raise UnsupportedImageError("YCbCr TIFFs with a strip or tile past the end "
                                                "of the file are not supported: libtiff's RGBA "
                                                "reader gives Pillow the rows before it")
                raise ValueError("TIFF strip or tile is truncated")
            chunk = data[start:end]
        if fill == 2 and compression != 7:  # libtiff's JPEG codec takes the bytes as they are
            chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
        if compression in (8, 32946, 34925, 50000):
            try:
                chunk = _inflate(compression, chunk, size)
            except ValueError as e:
                if rgba:
                    raise UnsupportedImageError(f"{e}: libtiff's RGBA reader decodes such YCbCr "
                                                "TIFFs with a warning") from None
                raise
        if compression in (1, 8, 32946, 34925, 50000):
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
    tables = b""
    if compression == 7 and 347 in tags:
        tables = tags[347][0] if isinstance(tags[347][0], bytes) else bytes(tags[347])
    if sampling is None:
        sampling = tuple(jpeg.parse(chunks[0], tables, blocks=False).sampling[0])
    return Tiff(w, h, mode, raw, photometric, bps[0], spp,
                1 if compression in (8, 32946, 34925, 50000) else compression, predictor, planar,
                tiled, cw, ch, chunks, order == MM, colormap, _int(tags, 274, 1), tables, sampling,
                luma, ref, _int(tags, 292, 0) if compression == 3 else 0, rgba,
                order == MM and compression != 1 and raw in _SWAPPED_RAW)


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_tiff

    lib = ctypes.CDLL(str(build_tiff()))
    i64p, c_int = ctypes.POINTER(ctypes.c_int64), ctypes.c_int
    lib.icat_tiff_decode.restype = c_int
    lib.icat_tiff_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64p, i64p, ctypes.c_int64, *[c_int] * 15,
        ctypes.c_void_p, ctypes.c_char_p, c_int]
    return lib


def decode_samples(t: Tiff) -> np.ndarray:
    """(H, W, samples) samples of a parsed TIFF, uint16 (uint32 for 32-bit
    samples), by ``csrc/tiff.cc``; JPEG chunks by ``jpeg_samples``.
    Raises ``UnsupportedImageError`` on a CCITT chunk that does not decode
    whole (``io/fax.py``'s outcomes other than ``OK``)."""
    if t.compression == 7:
        return jpeg_samples(t)
    joined = b"".join(t.chunks)
    lengths = np.array([len(c) for c in t.chunks], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    buf = np.frombuffer(joined or b"\0", np.uint8)
    out = np.empty((t.height, t.width, t.samples), np.uint32 if t.bits == 32 else np.uint16)
    err = ctypes.create_string_buffer(256)
    rc = _native().icat_tiff_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(joined), len(t.chunks),
        t.compression, t.width, t.height, t.chunk_w, t.chunk_h, int(t.tiled), t.planar, t.samples,
        t.bits, t.predictor, int(t.big_endian), *t.ycbcr, t.fax_options, out.ctypes.data, err,
        len(err))
    if rc == 2:
        raise UnsupportedImageError(f"{err.value.decode()}: libtiff warns and decodes on, or "
                                    "fails, by rules this reader does not follow; such CCITT "
                                    "TIFFs are not supported")
    if rc:
        raise ValueError(err.value.decode())
    return out


# the colour space libtiff has libjpeg decode a JPEG chunk in, by the TIFF's
# photometric interpretation: YCbCr to RGB (JPEGCOLORMODE_RGB, which
# Pillow sets), the rest as coded (JCS_UNKNOWN)
_JPEG_COLOURS = {1: ("gray", 1), 2: ("rgb", 3), 6: ("ycc", 3)}


def jpeg_frames(t: Tiff) -> List[jpeg.Frame]:
    """Each JPEG strip or tile of a parsed TIFF as a frame of ``io/jpeg.py``,
    with the file's tables and the colour space libtiff gives it; raises
    where libtiff's ``JPEGPreDecode`` refuses the chunk (a size other than
    the strip's or tile's, sampling factors other than the TIFF's)."""
    colour, ncomp = _JPEG_COLOURS[t.photometric]
    frames = []
    for i, chunk in enumerate(t.chunks):
        y0 = i // (-(-t.width // t.chunk_w) if t.tiled else 1) * t.chunk_h
        rows = t.chunk_h if t.tiled else min(t.chunk_h, t.height - y0)
        f = jpeg.parse(chunk, t.jpeg_tables, blocks=False)
        for scan in f.scans:  # libtiff ends a cut strip with a fake EOI and a warning
            scan.ended = True
        if len(f.sampling) != ncomp:
            raise ValueError(f"TIFF JPEG chunk of {len(f.sampling)} components where the "
                             f"photometric interpretation {t.photometric} needs {ncomp}")
        if (f.width, f.height) != (t.chunk_w, rows):
            raise UnsupportedImageError(
                f"TIFF JPEG chunks of {f.width}x{f.height} in strips or tiles of "
                f"{t.chunk_w}x{rows} are not supported (libtiff warns or fails)")
        want = t.ycbcr if t.photometric == 6 else (1, 1)
        if ncomp == 3 and (tuple(f.sampling[0]) != want
                           or any(s != (1, 1) for s in f.sampling[1:])):
            raise ValueError(f"TIFF JPEG chunk sampled {f.sampling} where libtiff expects {want} "
                             "for the first component and 1x1 for the others")
        f.colour = colour
        f.mode = "L" if ncomp == 1 else "RGB"
        frames.append(f)
    return frames


def jpeg_samples(t: Tiff) -> np.ndarray:
    """(H, W, 1 or 3) uint8 pixels of a JPEG-compressed TIFF: each strip or
    tile decoded by the host JPEG decoder (``jpeg.decode_frame_native``)
    and put in its place, tiles cut at the right and bottom edges."""
    out = np.empty((t.height, t.width, 1 if t.photometric == 1 else 3), np.uint8)
    across = -(-t.width // t.chunk_w) if t.tiled else 1
    for i, f in enumerate(jpeg_frames(t)):
        y0, x0 = i // across * t.chunk_h, i % across * t.chunk_w
        pixels = jpeg.decode_frame_native(f)
        out[y0:y0 + f.height, x0:x0 + f.width] = pixels[:t.height - y0, :t.width - x0]
    return out


def _code2v(c, rb: np.float32, rw: np.float32, cr: float) -> np.ndarray:
    """tif_color.c's Code2V in float arithmetic: (c - (int)RB) * CR / (RW - RB)."""
    den = rw - rb
    den = den if den != 0 else np.float32(1)
    return (np.asarray(c - int(rb), np.float32) * np.float32(cr)) / den


def _clampf(f: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """tif_color.c's CLAMP (NaN to the low end)."""
    f = np.asarray(f, np.float32)
    return np.where(~(f >= lo), np.float32(lo), np.where(f > hi, np.float32(hi), f))


@functools.lru_cache(maxsize=16)
def ycbcr_tables(luma: Tuple[float, ...], ref: Tuple[float, ...]) -> Tuple[np.ndarray, ...]:
    """libtiff's ``TIFFYCbCrToRGBInit`` tables (Y, Cr->R, Cb->B, Cr->G,
    Cb->G; int64 of 256), in its float and 16-bit fixed-point arithmetic."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rbw = [f32(v) for v in ref]

    def fix(x) -> int:  # FIX: (int32_t)(x * 65536 + 0.5), x a float >= 0
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * lr
    d1 = fix(_clampf(f1, 0, 2))
    d2 = -fix(_clampf(lr * f1 / lg, 0, 2))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(_clampf(f3, 0, 2))
    d4 = -fix(_clampf(lb * f3 / lg, 0, 2))
    x = np.arange(256, dtype=np.int64) - 128
    cr = np.trunc(_clampf(_code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127), -4096, 4096))
    cb = np.trunc(_clampf(_code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127), -4096, 4096))
    cr, cb = cr.astype(np.int64), cb.astype(np.int64)
    y = np.trunc(_clampf(_code2v(x + 128, rbw[0], rbw[1], 255), -4096, 4096)).astype(np.int64)
    half = 1 << 15
    return y, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr, d4 * cb + half


def ycbcr_to_rgb(t: Tiff, s: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of (H, W, 3) Y, Cb, Cr samples by libtiff's
    ``TIFFYCbCrtoRGB``."""
    y_tab, cr_r, cb_b, cr_g, cb_g = ycbcr_tables(t.luma, t.ref_black_white)
    y, cb, cr = (s[..., k].astype(np.int64) for k in range(3))
    yv = y_tab[y]
    rgb = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16), yv + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _gray(v: np.ndarray) -> np.ndarray:
    return np.repeat(v.astype(np.uint8)[..., None], 3, -1)


def to_rgb(t: Tiff, s: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's ``convert("RGB")`` of the mode ``t`` opens
    as, from its (H, W, samples) samples."""
    if t.mode in ("I", "F"):
        if t.swapped:
            s = s.byteswap()  # what Pillow unpacks from libtiff's swapped samples
        if t.mode == "I":  # i2rgb: int32 clipped to 0..255
            v = (s[..., 0].astype(np.int16) if t.bits == 16 else s[..., 0].view(np.int32))
            return _gray(np.clip(v, 0, 255))
        f = s[..., 0].view(np.float32)  # f2l: clipped, truncated, NaN as 0
        with np.errstate(invalid="ignore"):
            v = np.where(f <= 0, 0, np.where(f >= 255, 255, np.nan_to_num(f, nan=0.0)))
        return _gray(v.astype(np.int64))
    if t.mode in ("1", "L", "LA"):
        v = s[..., 0].astype(np.int64)
        v = v * 255 // ((1 << t.bits) - 1) if t.bits < 8 else v
        return _gray(255 - v if t.photometric == 0 else v)
    if t.mode in ("I;16", "I;16B"):
        return _gray(np.minimum(s[..., 0], 255))
    if t.mode in ("P", "PA"):
        return t.colormap[s[..., 0]]
    if t.mode == "LAB":  # Pillow's LAB unpacker flips a's and b's sign bits
        return cielab.lab_to_rgb(s[..., :3] ^ np.array([0, 128, 128], np.uint16))
    if t.rgba:
        return ycbcr_to_rgb(t, s)
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

def fax_samples(t: Tiff) -> Tuple[np.ndarray, int]:
    """(H, W, 1) uint16 samples of a parsed CCITT TIFF and the worst of its
    chunks' outcomes (``fax.OK`` ... ``fax.CUT``), by the plain Python
    decoder ``io/fax.py``: ``decode_samples``'s numbers, slowly."""
    out = np.zeros((t.height, t.width, 1), np.uint16)
    across = -(-t.width // t.chunk_w) if t.tiled else 1
    worst = fax.OK
    for i, chunk in enumerate(t.chunks):
        y0, x0 = i // across * t.chunk_h, i % across * t.chunk_w
        rows = t.chunk_h if t.tiled else min(t.chunk_h, t.height - y0)
        bits, outcome = fax.decode(chunk, t.compression, t.fax_options, t.chunk_w, rows)
        part = bits[:t.height - y0, :t.width - x0]
        out[y0:y0 + part.shape[0], x0:x0 + part.shape[1], 0] = part
        worst = max(worst, outcome, key=(fax.OK, fax.WARNED, fax.CUT, fax.FAILED).index)
    return out, worst


def decode_tiff_native(t: Tiff) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a parsed TIFF, orientation undone."""
    try:
        samples = decode_samples(t)
    except ValueError as e:
        if not t.rgba or isinstance(e, UnsupportedImageError):
            raise
        raise UnsupportedImageError(f"{e}: libtiff's RGBA reader decodes such YCbCr TIFFs with "
                                    "a warning") from None
    rgb = to_rgb(t, samples)
    return np.ascontiguousarray(_ORIENT.get(t.orientation, lambda a: a)(rgb))


def decode_native(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a TIFF file's first image, as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder.  Raises what
    ``parse`` raises, ``ValueError`` on broken strips and ``RuntimeError``
    where the decoder cannot be built."""
    return decode_tiff_native(parse(data))
