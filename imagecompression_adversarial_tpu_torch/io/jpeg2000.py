"""JPEG 2000 in host C++, without PIL: a JP2 file's or a raw codestream's
pixels as Pillow's ``Image.open(path).convert("RGB")`` gives them, and the
mode Pillow opens it as.

Pillow reads JPEG 2000 through OpenJPEG, tile by tile
(``opj_read_tile_header``, ``opj_decode_tile_data``), and unpacks each
tile's samples itself (``Jpeg2KDecode.c``'s ``j2ku_*``).  So does this
module:

* ``parse`` tells the container by its first bytes (the JP2 signature box,
  or ``FF 4F FF 51``); of a JP2 file it walks the boxes as Pillow's
  ``Jpeg2KImagePlugin`` does for the size and the mode (``ihdr``: ``L``,
  ``I;16`` past 8 bits, ``LA``, ``RGB``, ``RGBA``; ``colr`` enumerated 12
  on four components: ``CMYK``; ``pclr`` of at most 8-bit entries over
  ``L``/``LA``: ``P``/``PA``, its palette built with Pillow's
  ``getcolor``, which folds repeated colours) and as OpenJPEG does for the
  colour space (the first ``colr``: 16 sRGB, 17 gray, 18 sYCC, 24 e-sYCC,
  12 CMYK, anything else unknown) and the codestream (``jp2c``); of a raw
  codestream, the SIZ's component count and depth;
* it reads the codestream's marker segments as OpenJPEG 2.5 does: SIZ,
  COD and COC (levels, code-block size and style, 9/7 or 5/3, precincts,
  progression, layers, MCT, SOP/EPH), QCD and QCC (none, derived or
  expounded, guard bits), RGN (maxshift), POC, PPM and PPT, TLM, PLM, PLT,
  CRG and COM (skipped), then each tile-part (SOT, its header, SOD) in
  any order of tiles, up to EOC;
* ``decode_native`` hands each tile, with its parameters as flat arrays,
  to the host C++ decoder (``csrc/jpeg2000.cc``: tier 2, tier 1, ROI,
  dequantisation, the inverse 5/3 or 9/7, RCT or ICT, level shift and
  clamping, in OpenJPEG's arithmetic), then lays the samples out as
  OpenJPEG's tile buffer and unpacks them as Pillow does: the shift and
  rounding of components past 8 bits, their wrap to 8 bits, sYCC through
  Pillow's ``ImagingConvertYCbCr2RGB`` and subsampled components repeated
  (with Pillow's floor-divided strides); then Pillow's ``convert("RGB")``.

What Pillow reads and this module does not (HTJ2K code-blocks, the
Part 2 extensions) raises ``UnsupportedImageError``, naming it.  What
OpenJPEG refuses in its default strict mode (a codestream cut short, a
missing EOC, a component layout no unpacker of Pillow's takes, ...)
raises ``ValueError``, as Pillow raises ``OSError``.

There is no numpy twin of the C++ decoder, as for WebP: its referee is
Pillow on the CPU (``tests/test_torch_jpeg2000.py``) and, on the card,
the sha256 of Pillow's pixels recorded in ``tests/data/inputs/inputs.json``.
A library that cannot be built raises; nothing falls back to another
reader.
"""

from __future__ import annotations

import base64
import ctypes
import dataclasses
import functools
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import jpeg
from .errors import UnsupportedImageError, check_size

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# OpenJPEG's colour spaces, by a JP2 colr box's enumerated space
_ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
_MAX_RES, _MAX_BANDS = 33, 97
_COMP_STRIDE = 16 + 2 * _MAX_RES + 2 * _MAX_BANDS  # csrc/jpeg2000.cc's kCompStride
_HT, _HT_MIXED = 0x40, 0x80  # COD/COC code-block style bits of Part 15

# the Part 2 marker segments OpenJPEG reads (array-based multiple component
# transforms), which this decoder does not
_PART2_MARKERS = {0xFF74: "MCT", 0xFF75: "MCC", 0xFF77: "MCO", 0xFF78: "CBD"}
# the markers OpenJPEG knows, and where it takes them: the main header ("m"),
# a tile-part header ("t"), neither ("")
_KNOWN = {0xFF90: "m", 0xFF52: "mt", 0xFF53: "mt", 0xFF5E: "mt", 0xFF5C: "mt", 0xFF5D: "mt",
          0xFF5F: "mt", 0xFF51: "", 0xFF55: "m", 0xFF57: "m", 0xFF58: "t", 0xFF60: "m",
          0xFF61: "t", 0xFF91: "", 0xFF63: "m", 0xFF64: "mt", 0xFF74: "mt", 0xFF78: "m",
          0xFF50: "m", 0xFF59: "m", 0xFF75: "mt", 0xFF77: "mt"}

# Pillow 12.1.0's ImagingConvertYCbCr2RGB, per channel:
#   r = y + R[cr], g = y + ((GCb[cb] + GCr[cr]) >> 6), b = y + B[cb], clipped;
# R and B are its tables after the shift, GCb and GCr integer tables that
# give its G for every (cb, cr).  Solved from Pillow's conversion and held
# to it over all 2**24 inputs (tests/test_torch_jpeg2000.py).
_YCC = np.frombuffer(base64.b64decode(
    "TP9N/0//UP9S/1P/VP9W/1f/Wf9a/1v/Xf9e/2D/Yf9i/2T/Zf9n/2j/av9r/2z/bv9v/3H/cv9z/3X/dv94/3n/ev98"
    "/33/f/+A/4H/g/+E/4b/h/+I/4r/i/+N/47/j/+R/5L/lP+V/5b/mP+Z/5v/nP+d/5//oP+i/6P/pP+m/6f/qf+q/6v/"
    "rf+u/7D/sf+y/7T/tf+3/7j/uf+7/7z/vv+//8D/wv/D/8X/xv/H/8n/yv/M/83/zv/Q/9H/0//U/9X/1//Y/9r/2//c"
    "/97/3//h/+L/4//l/+b/6P/p/+r/7P/t/+//8P/y//P/9P/2//f/+f/6//v//f/+/wAAAQACAAQABQAHAAgACQALAAwA"
    "DgAPABAAEgATABUAFgAXABkAGgAcAB0AHgAgACEAIwAkACUAJwAoACoAKwAsAC4ALwAxADIAMwA1ADYAOAA5ADoAPAA9"
    "AD8AQABBAEMARABGAEcASABKAEsATQBOAE8AUQBSAFQAVQBWAFgAWQBbAFwAXQBfAGAAYgBjAGQAZgBnAGkAagBrAG0A"
    "bgBwAHEAcgB0AHUAdwB4AHkAewB8AH4AfwCAAIIAgwCFAIYAiACJAIoAjACNAI8AkACRAJMAlACWAJcAmACaAJsAnQCe"
    "AJ8AoQCiAKQApQCmAKgAqQCrAKwArQCvALAAsgAd/x7/IP8i/yT/Jv8n/yn/K/8t/y7/MP8y/zT/Nv83/zn/O/89/z7/"
    "QP9C/0T/Rf9H/0n/S/9N/07/UP9S/1T/Vf9X/1n/W/9c/17/YP9i/2T/Zf9n/2n/a/9s/27/cP9y/3T/df93/3n/e/98"
    "/37/gP+C/4P/hf+H/4n/i/+M/47/kP+S/5P/lf+X/5n/m/+c/57/oP+i/6P/pf+n/6n/qv+s/67/sP+y/7P/tf+3/7n/"
    "uv+8/77/wP/C/8P/xf/H/8n/yv/M/87/0P/R/9P/1f/X/9n/2v/c/97/4P/h/+P/5f/n/+j/6v/s/+7/8P/x//P/9f/3"
    "//j/+v/8//7/AAABAAMABQAHAAgACgAMAA4ADwARABMAFQAXABgAGgAcAB4AHwAhACMAJQAmACgAKgAsAC4ALwAxADMA"
    "NQA2ADgAOgA8AD4APwBBAEMARQBGAEgASgBMAE0ATwBRAFMAVQBWAFgAWgBcAF0AXwBhAGMAZQBmAGgAagBsAG0AbwBx"
    "AHMAdAB2AHgAegB8AH0AfwCBAIMAhACGAIgAigCLAI0AjwCRAJMAlACWAJgAmgCbAJ0AnwChAKMApACmAKgAqgCrAK0A"
    "rwCxALIAtAC2ALgAugC7AL0AvwDBAMIAxADGAMgAygDLAM0AzwDRANIA1ADWANgA2QDbAN0A3wDhAG30Y/Q19C30//P1"
    "8+vzv/O186nzf/Nz82nzPvMx8ynz/PLx8ujyuvKx8qbyevJw8mXyOvIu8iXy9/Ht8eTxtfGt8aLxdfFs8T/xNfEq8f/w"
    "9PDp8L/wsvCp8H3wcfBp8DvwMfAn8Prv8e/l77rvr++l73nvbe9l7zfvLe8k7/Xu7e7i7rXurO5/7nXuae4/7jPuKe7+"
    "7fHt6e287bHtqO167XHtZu067TDtJe367O7s5ey47K3spex27G3sY+w17C3s/+v16+vrv+u166nrf+tz62nrPusx6ynr"
    "++rx6ufquuqx6qXqeupv6mXqOeot6iXq9+nt6eTptemt6aLpdels6T/pNekr6f/o9ejp6L/os+ip6H7ocehp6DzoMego"
    "6Prn8efm57rnsOel53nnbedl5zfnLeck5/Xm7ebi5rXmrOZ/5nXmauY/5jTmKeb/5fLl6eW95bHlqeV75XHlZ+U65THl"
    "JeX65O/k5eS55K3kpeR35G3kZOQ15C3k/+P14+vjv+O146njf+Nz42njPuMx4ynj/OLx4ujiuuKx4qbieuJw4mXiOuIu"
    "4iXi+OHt4eXhtuGt4aPhdeFt4T/hNeEr4f/g9eDp4L/gsuCp4H3gceBp4DvgMeAn4Prf8d/l37rfr9+l33nfbd9l3zff"
    "Ld8k3/Xe7d7i3rXerN5/3nXegS1LLRMt2yzGLI8sVyxBLAss0yubK4YrTysXKwEryyqTKlsqRyoPKtcpwSmLKVMpGykH"
    "Kc8olyiBKEsoEyjbJ8cnjydXJ0InCyfTJpsmhyZPJhcmAibLJZMlXCVHJQ8l1yTCJIskUyQcJAckzyOXI4IjSyMTI9wi"
    "xyKPIlgiQiILItMhnCGHIU8hGCECIcsgkyBcIEcgDyDYH8Ifix9UHxwfBx/PHpgegh5LHhQe3B3HHY8dWB1CHQsd1Byc"
    "HIccUBwYHAIcyxuUG1wbRxsQG9gawhqMGlQaHBoHGtAZmBmCGUwZFBncGMcYkBhYGEIYDBjUF5wXiBdQFxgXAhfMFpQW"
    "XRZJFhEW2RXDFY0VVRUdFQkV0RSZFIQUTRQVFN0TyRORE1kTRBMNE9USnRKJElESGRIEEs0RlRFeEUkRERHZEMQQjRBV"
    "EB4QCRDRD5oPhA9NDxUP3g7JDpEOWg5EDg0O1Q2eDYkNUQ0aDQQNzQyWDF4MSQwRDNoLxAuNC1YLHgsJC9EKmgqECk0K"
    "FgreCckJkglaCUQJDQnWCJ4IiQhSCBoIBAjNB5YHXgdJBxIH2gbEBo4GVgYeBgkG0gWaBYQFTgUWBd4EygSSBFoERAQO"
    "BNYDngOKA1IDGgMEA84ClgJeAkoCEgLaAcUBjgFWAR4BCgHSAJoAhQBOABYAAAA="), "<i2").astype(np.int64).reshape(4, 256)


@dataclasses.dataclass
class Coding:
    """A component's coding style and quantisation (COD/COC, QCD/QCC, RGN)."""

    numres: int = 0
    cblkw: int = 0
    cblkh: int = 0
    cblksty: int = 0
    qmfbid: int = 0
    precincts: Tuple[Tuple[int, int], ...] = ()
    qntsty: int = 0
    numgbits: int = 0
    steps: Tuple[Tuple[int, int], ...] = ()  # (exponent, mantissa) a band
    roishift: int = 0


@dataclasses.dataclass
class TileCoding:
    """A tile's coding parameters: the main header's, then its own."""

    prog: int = 0
    numlayers: int = 0
    mct: int = 0
    csty: int = 0
    comps: List[Coding] = dataclasses.field(default_factory=list)
    pocs: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)

    def copy(self) -> "TileCoding":
        return TileCoding(self.prog, self.numlayers, self.mct, self.csty,
                          [dataclasses.replace(c) for c in self.comps], list(self.pocs))


@dataclasses.dataclass
class Tile:
    index: int
    coding: TileCoding
    parts: List[bytes] = dataclasses.field(default_factory=list)
    ppt: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    tile_parts: int = 0  # TNsot, once a SOT of the tile gives it
    done_at: int = -1  # the tile-part after which OpenJPEG decodes the tile


@dataclasses.dataclass
class Jpeg2000:
    """A parsed JPEG 2000 file: Pillow's size and mode (and palette, of a
    ``P``/``PA`` file), OpenJPEG's colour space, the SIZ and the tiles."""

    width: int
    height: int
    mode: str
    color_space: str
    palette: Optional[np.ndarray]
    x0: int
    y0: int
    x1: int
    y1: int
    tile_grid: Tuple[int, int, int, int]  # XTOsiz, YTOsiz, XTsiz, YTsiz
    comps: List[Tuple[int, int, int, int]]  # (precision, signed, dx, dy)
    tiles: List[Tile]  # in the order OpenJPEG decodes them
    ppm: Optional[bytes] = None  # every PPM segment's Ippm bytes, one stream


class _Reader:
    def __init__(self, data: bytes, pos: int = 0, end: Optional[int] = None):
        self.data, self.pos = data, pos
        self.end = len(data) if end is None else end

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise ValueError("JPEG 2000 codestream is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))


def _pillow_palette(entries: List[Tuple[int, ...]], npc: int) -> np.ndarray:
    """Pillow's RGB or RGBA ImagePalette after ``getcolor`` of each entry in
    turn: a repeated colour keeps its first index, so later entries move
    up."""
    if npc not in (3, 4):
        raise UnsupportedImageError(f"a JPEG 2000 palette of {npc} columns, which Pillow "
                                    "packs into its palette unaligned")
    seen = set()
    colours: List[Tuple[int, ...]] = []
    for colour in entries:
        if colour in seen:
            continue
        if len(colours) >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        seen.add(colour)
        colours.append(colour)
    return np.array(colours, np.uint8).reshape(-1, npc)


def _jp2(data: bytes):
    """(Pillow's size, mode and palette; OpenJPEG's colour space; the
    codestream) of a JP2 file."""
    # Pillow: boxes up to jp2h, then its ihdr, colr, pclr
    r = _Reader(data, 12)
    header = None
    while r.pos < r.end:
        lbox, tbox = r.u("I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = r.u("Q")[0], 16
        if lbox < hlen or r.pos + lbox - hlen > r.end:
            raise ValueError("JP2 box has an invalid header length")
        if tbox == b"jp2h":
            header = _Reader(data, r.pos, r.pos + lbox - hlen)
            break
        r.pos += lbox - hlen
    if header is None:
        raise ValueError("JP2 file has no jp2h box")
    size = mode = nc = palette = None
    while header.pos < header.end:
        lbox, tbox = header.u("I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = header.u("Q")[0], 16
        if lbox < hlen or header.pos + lbox - hlen > header.end:
            raise ValueError("JP2 box has an invalid header length")
        box = _Reader(data, header.pos, header.pos + lbox - hlen)
        header.pos += lbox - hlen
        if tbox == b"ihdr":
            height, width, nc, bpc = box.u("IIHB")
            size = (width, height)
            mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                    {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = box.u("BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = box.u("HB")
            depths = box.u("B" * npc)
            if max(depths, default=0) <= 8:
                entries = [box.u("B" * npc) for _ in range(ne)]
                palette = _pillow_palette(entries, npc)
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise ValueError("Malformed JP2 header")
    # OpenJPEG: the signature, ftyp, then jp2h (ihdr, the first colr), jp2c
    r = _Reader(data, 12)
    color_space, codestream, seen, ihdr = "unknown", None, [], None
    while r.pos < r.end:
        start = r.pos
        lbox, tbox = r.u("I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = r.u("Q")[0], 16
        elif lbox == 0:
            lbox = r.end - start
        if lbox < hlen:
            raise ValueError("JP2 box is shorter than its header")
        seen.append(tbox)
        if tbox == b"jp2c":  # OpenJPEG reads the codestream on, whatever the length says
            codestream = data[start + hlen:]
            break
        if start + lbox > r.end:
            raise ValueError("JP2 box runs past the end of the file")
        if tbox == b"jp2h":
            sub = _Reader(data, start + hlen, start + lbox)
            colr = False
            if data[sub.pos + 4:sub.pos + 8] != b"ihdr":
                raise ValueError("JP2 jp2h box does not start with ihdr")
            ihdr = _Reader(data, sub.pos + 8, sub.end).u("IIH")
            while sub.pos < sub.end:
                s_start = sub.pos
                l2, t2 = sub.u("I4s")
                if l2 < 8 or s_start + l2 > sub.end:
                    raise ValueError("JP2 box runs past its jp2h box")
                if t2 == b"colr" and not colr:
                    colr = True
                    body = _Reader(data, sub.pos, s_start + l2)
                    meth = body.u("BBB")[0]
                    if meth == 1:
                        color_space = _ENUMCS.get(body.u("I")[0], "unknown")
                sub.pos = s_start + l2
        r.pos = start + lbox
    if not seen or seen[0] != b"ftyp":
        raise ValueError("JP2 file's ftyp box is not its second box")
    if b"jp2h" not in seen:
        raise ValueError("JP2 file has no jp2h box")
    if codestream is None:
        raise ValueError("JP2 file has no jp2c box")
    return size, mode, palette, color_space, codestream, ihdr


def _cod_params(r: _Reader, coding: Coding, scod: int) -> None:
    levels, xcb, ycb, cblksty, transform = r.u("BBBBB")
    if levels + 1 > _MAX_RES:
        raise ValueError(f"JPEG 2000 has {levels} decomposition levels, past 32")
    cblkw, cblkh = xcb + 2, ycb + 2
    if cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12:
        raise ValueError(f"JPEG 2000 code-blocks of 2**{cblkw} x 2**{cblkh} are not valid")
    if cblksty & _HT:
        raise UnsupportedImageError(
            "an HTJ2K (JPEG 2000 Part 15) codestream, whose HT code-blocks Pillow's OpenJPEG "
            "decodes and the port does not")
    if cblksty & _HT_MIXED:
        raise ValueError("JPEG 2000 mixed HT code-blocks, which OpenJPEG refuses")
    if transform > 1:  # a Part 2 wavelet, which OpenJPEG refuses
        raise ValueError(f"JPEG 2000 wavelet transform {transform} is not 9/7 or 5/3")
    if scod & 1:
        precincts = []
        for res in range(levels + 1):
            b = r.u("B")[0]
            pw, ph = b & 15, b >> 4
            if res and (pw == 0 or ph == 0):
                raise ValueError("JPEG 2000 precinct size of 1 past resolution 0")
            precincts.append((pw, ph))
    else:
        precincts = [(15, 15)] * (levels + 1)
    coding.numres, coding.cblkw, coding.cblkh = levels + 1, cblkw, cblkh
    coding.cblksty, coding.qmfbid, coding.precincts = cblksty, transform, tuple(precincts)


def _qcd_params(r: _Reader, coding: Coding) -> None:
    """SQcd/SQcc and the step sizes, as OpenJPEG reads them: style 0 one
    byte a band, 1 one band that the others derive from, any other two
    bytes a band; bands past 97 dropped, bands not given 0."""
    sq = r.u("B")[0]
    style, guard = sq & 0x1F, sq >> 5
    left = r.end - r.pos
    if style == 0:
        steps = [(b >> 3, 0) for b in r.take(left)]
    else:
        n = 1 if style == 1 else left // 2
        steps = [(v >> 11, v & 0x7FF) for v in r.u("H" * n)]
    if style == 1:
        e0, m0 = steps[0]
        steps += [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, _MAX_BANDS)]
    steps = (steps + [(0, 0)] * _MAX_BANDS)[:_MAX_BANDS]
    coding.qntsty, coding.numgbits, coding.steps = style, guard, tuple(steps)


def _comp_index(r: _Reader, ncomp: int) -> int:
    c = r.u("B" if ncomp < 257 else "H")[0]
    if c >= ncomp:
        raise ValueError(f"JPEG 2000 marker names component {c} of {ncomp}")
    return c


def _coding_marker(marker: int, r: _Reader, tc: TileCoding, ncomp: int) -> None:
    """Apply a COD, COC, QCD, QCC, RGN or POC segment to ``tc``."""
    if marker == 0xFF52:  # COD: every component
        scod = r.u("B")[0]
        tc.prog, tc.numlayers, tc.mct = r.u("BHB")
        if tc.prog > 4:
            raise ValueError(f"JPEG 2000 progression order {tc.prog} is not valid")
        if tc.numlayers == 0:
            raise ValueError("JPEG 2000 COD has no layer")
        if tc.mct > 1:
            raise ValueError(f"JPEG 2000 multiple component transform {tc.mct}, which OpenJPEG "
                             "refuses")
        tc.csty = scod
        base = Coding()
        _cod_params(r, base, scod)
        for c in tc.comps:
            c.numres, c.cblkw, c.cblkh, c.cblksty, c.qmfbid, c.precincts = (
                base.numres, base.cblkw, base.cblkh, base.cblksty, base.qmfbid, base.precincts)
    elif marker == 0xFF53:  # COC
        c = _comp_index(r, ncomp)
        _cod_params(r, tc.comps[c], r.u("B")[0])
    elif marker == 0xFF5C:  # QCD: every component
        base = Coding()
        _qcd_params(r, base)
        for c in tc.comps:
            c.qntsty, c.numgbits, c.steps = base.qntsty, base.numgbits, base.steps
    elif marker == 0xFF5D:  # QCC
        c = _comp_index(r, ncomp)
        _qcd_params(r, tc.comps[c])
    elif marker == 0xFF5E:  # RGN
        c = _comp_index(r, ncomp)
        style, shift = r.u("BB")
        if style != 0:
            raise ValueError(f"JPEG 2000 ROI style {style} is not valid")
        tc.comps[c].roishift = shift
    elif marker == 0xFF5F:  # POC
        wide = ncomp >= 257
        fmt = "BHHBHB" if wide else "BBHBBB"
        size = struct.calcsize(">" + fmt)
        if (r.end - r.pos) % size or r.end == r.pos:
            raise ValueError("JPEG 2000 POC segment has a bad length")
        while r.pos < r.end:
            r0, c0, l1, r1, c1, prg = r.u(fmt)
            if prg > 4:
                raise ValueError(f"JPEG 2000 progression order {prg} is not valid")
            tc.pocs.append((r0, c0, l1, r1, min(c1, ncomp), prg))


def _marker(r: _Reader, where: str, end_marker: int) -> int:
    """The next marker of a header (``where`` "m" or "t"), past unknown
    ones as OpenJPEG's ``opj_j2k_read_unk`` skips them: two bytes at a
    time, up to a marker it knows."""
    marker, = r.u("H")
    if marker < 0xFF00:
        raise ValueError(f"JPEG 2000 holds {marker:#06x} where a marker belongs")
    if marker == end_marker or marker in _KNOWN or marker in _PART2_MARKERS:
        return marker
    while True:
        marker, = r.u("H")
        if marker < 0xFF00:
            continue
        if marker == end_marker:
            return marker
        if marker in _KNOWN:
            if where not in _KNOWN[marker]:
                raise ValueError(f"JPEG 2000 marker {marker:#06x} where it does not belong")
            return marker


def parse(data: bytes) -> Jpeg2000:
    """Pillow's size, mode and palette and OpenJPEG's colour space, SIZ and
    tiles of a JP2 file or raw codestream.  Raises ``ValueError`` on a
    broken file and ``UnsupportedImageError`` on a kind the decoder does
    not take."""
    palette = None
    if data[:12] == JP2_SIGNATURE:
        (width, height), mode, palette, color_space, cs, ihdr = _jp2(data)
        if cs[:4] != J2K_SIGNATURE:
            raise ValueError("JP2 codestream does not start with SOC and SIZ")
    elif data[:4] == J2K_SIGNATURE:
        cs, color_space, mode, ihdr = data, "unspecified", None, None
    else:
        raise ValueError("not a JPEG 2000 file")
    r = _Reader(cs, 4)
    lsiz, rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz = r.u("HHIIIIIIIIH")
    if lsiz != 38 + 3 * csiz or csiz == 0:
        raise ValueError("JPEG 2000 SIZ has a bad length")
    comps = []
    for _ in range(csiz):
        ssiz, dx, dy = r.u("BBB")
        prec, sgnd = (ssiz & 0x7F) + 1, ssiz >> 7
        if prec > 31:
            raise ValueError(f"JPEG 2000 component of {prec} bits, past OpenJPEG's 31")
        if dx == 0 or dy == 0:
            raise ValueError("JPEG 2000 component subsampling of 0")
        comps.append((prec, sgnd, dx, dy))
    if ihdr is not None and (ihdr[1] != xsiz - xo or ihdr[0] != ysiz - yo or ihdr[2] != csiz):
        raise ValueError(f"JP2 ihdr {ihdr} disagrees with the SIZ, which OpenJPEG refuses")
    if mode is None:  # Pillow's _parse_codestream
        if csiz == 1:
            mode = "I;16" if comps[0][0] > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
            if mode is None:
                raise ValueError("unable to determine J2K image mode")
        width, height = xsiz - xo, ysiz - yo
    check_size("JPEG 2000", width, height)
    if xsiz <= xo or ysiz <= yo or xt == 0 or yt == 0 or xto > xo or yto > yo \
            or xto + xt <= xo or yto + yt <= yo:
        raise ValueError("JPEG 2000 SIZ has an invalid image or tile grid")
    if csiz > 4:
        raise ValueError(f"JPEG 2000 of {csiz} components, which Pillow refuses")
    if max(xsiz, ysiz, xt + xto, yt + yto) >= 2**31:
        raise UnsupportedImageError("a JPEG 2000 reference grid past 2**31, which the decoder's "
                                    "int32 coordinates do not hold")
    ntx, nty = -(-(xsiz - xto) // xt), -(-(ysiz - yto) // yt)
    if ntx * nty > 65535:
        raise ValueError("JPEG 2000 has more than 65535 tiles")
    default = TileCoding(comps=[Coding() for _ in comps])
    seen = set()
    ppm: Dict[int, bytes] = {}
    # the main header
    while True:
        marker = _marker(r, "m", 0xFF90)
        if marker == 0xFF90:
            r.pos -= 2
            break
        if "m" not in _KNOWN[marker]:
            raise ValueError(f"JPEG 2000 marker {marker:#06x} in the main header")
        length, = r.u("H")
        seg = _Reader(cs, r.pos, r.pos + length - 2)
        r.take(length - 2)
        if marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
            _coding_marker(marker, seg, default, csiz)
            seen.add(marker)
        elif marker == 0xFF60:
            if length < 4:  # OpenJPEG: "Error reading PPM marker"
                raise ValueError("JPEG 2000 PPM segment holds no header byte")
            z = seg.u("B")[0]
            if z in ppm:
                raise ValueError(f"JPEG 2000 Zppm {z} given twice")
            ppm[z] = seg.take(seg.end - seg.pos)
        elif marker in _PART2_MARKERS:
            raise UnsupportedImageError(
                f"a JPEG 2000 Part 2 (JPX) codestream (its {_PART2_MARKERS[marker]} marker)")
    if 0xFF52 not in seen or 0xFF5C not in seen:
        raise ValueError("JPEG 2000 main header lacks its COD or QCD")
    ppm_stream = None
    if ppm:  # opj_j2k_merge_ppm: the Nppm chunks' Ippm bytes, one stream
        stream = b"".join(ppm[z] for z in sorted(ppm))
        pr, pieces = _Reader(stream), []
        while pr.pos < pr.end:
            if pr.end - pr.pos < 4:
                raise ValueError("JPEG 2000 PPM segments are corrupted")
            n, = pr.u("I")
            pieces.append(pr.take(n))
        ppm_stream = b"".join(pieces)
    tiles: Dict[int, Tile] = {}
    parts = 0
    # the tile-parts
    while True:
        marker, = r.u("H")
        if marker == 0xFFD9:
            break
        if marker != 0xFF90:
            raise ValueError(f"JPEG 2000 holds {marker:#06x} where a tile-part or EOC belongs")
        start = r.pos - 2
        lsot, isot, psot, tpsot, tnsot = r.u("HHIBB")
        if lsot != 10:
            raise ValueError("JPEG 2000 SOT has a bad length")
        if isot >= ntx * nty:
            raise ValueError(f"JPEG 2000 tile {isot} is past the {ntx * nty} tiles")
        tile = tiles.get(isot)
        if tile is None:
            tile = tiles[isot] = Tile(isot, default.copy())
        # OpenJPEG's checks: tile-parts in order, each below the count given
        if tpsot != len(tile.parts):
            raise ValueError(f"JPEG 2000 tile {isot} holds tile-part {tpsot} where "
                             f"{len(tile.parts)} belongs")
        if tnsot:
            if tile.tile_parts and tpsot >= tile.tile_parts or tpsot >= tnsot:
                raise ValueError(f"JPEG 2000 tile-part {tpsot} of tile {isot} is past its count")
            tile.tile_parts = tnsot
        first = not tile.parts
        while True:
            marker = _marker(r, "t", 0xFF93)
            if marker == 0xFF93:
                break
            if "t" not in _KNOWN[marker]:
                raise ValueError(f"JPEG 2000 marker {marker:#06x} in a tile-part header")
            length, = r.u("H")
            seg = _Reader(cs, r.pos, r.pos + length - 2)
            r.take(length - 2)
            if marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E):
                if not first:
                    raise ValueError("JPEG 2000 coding marker in a later tile-part header")
                _coding_marker(marker, seg, tile.coding, csiz)
            elif marker == 0xFF5F:
                _coding_marker(marker, seg, tile.coding, csiz)
            elif marker == 0xFF61:
                if length < 4:  # OpenJPEG: "Error reading PPT marker"
                    raise ValueError("JPEG 2000 PPT segment holds no header byte")
                z = seg.u("B")[0]
                if z in tile.ppt:
                    raise ValueError(f"JPEG 2000 Zppt {z} given twice in tile {isot}")
                tile.ppt[z] = seg.take(seg.end - seg.pos)
            elif marker in _PART2_MARKERS:
                raise UnsupportedImageError(
                    f"a JPEG 2000 Part 2 (JPX) codestream (its {_PART2_MARKERS[marker]} marker)")
        end = r.end - 2 if psot == 0 else start + psot
        if end < r.pos or end > r.end:
            raise ValueError("JPEG 2000 tile-part runs past the end of the codestream")
        tile.parts.append(r.take(end - r.pos))
        if tile.tile_parts and len(tile.parts) == tile.tile_parts:
            tile.done_at = parts
        parts += 1
    if ppm_stream is not None and any(t.ppt for t in tiles.values()):
        raise ValueError("JPEG 2000 holds both PPM and PPT")
    # OpenJPEG decodes a tile once its last tile-part (by TNsot) is read, and
    # at EOC the others by index
    order = sorted(tiles.values(), key=lambda t: (t.done_at < 0, t.done_at, t.index))
    return Jpeg2000(width, height, mode, color_space, palette, xo, yo, xsiz, ysiz,
                    (xto, yto, xt, yt), comps, order, ppm_stream)


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_jpeg2000

    lib = ctypes.CDLL(str(build_jpeg2000()))
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    lib.icat_j2k_decode_tile.restype = ctypes.c_int
    lib.icat_j2k_decode_tile.argtypes = [i32p, i32p, i32p, u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), i32p,
                                         ctypes.c_char_p, ctypes.c_int]
    return lib


def _tile_bounds(j: Jpeg2000, index: int) -> Tuple[int, int, int, int]:
    xto, yto, xt, yt = j.tile_grid
    ntx = -(-(j.x1 - xto) // xt)
    p, q = index % ntx, index // ntx
    return (max(xto + p * xt, j.x0), max(yto + q * yt, j.y0),
            min(xto + (p + 1) * xt, j.x1), min(yto + (q + 1) * yt, j.y1))


def decode_tile_native(j: Jpeg2000, tile: Tile, ppm_at: int = 0) -> Tuple[List[np.ndarray], int]:
    """Each component's samples of one tile (int32, ceil-divided by its
    subsampling), as OpenJPEG gives them, by ``csrc/jpeg2000.cc``; and the
    bytes of the PPM stream its packet headers took from ``ppm_at`` on."""
    tx0, ty0, tx1, ty1 = _tile_bounds(j, tile.index)
    tc = tile.coding
    pocs = tc.pocs or [(0, 0, tc.numlayers, max(c.numres for c in tc.comps), len(j.comps),
                        tc.prog)]
    params = np.zeros((len(j.comps), _COMP_STRIDE), np.int32)
    for k, ((prec, sgnd, dx, dy), c) in enumerate(zip(j.comps, tc.comps)):
        params[k, :12] = (dx, dy, prec, sgnd, c.numres, c.cblkw, c.cblkh, c.cblksty, c.qmfbid,
                          c.qntsty, c.numgbits, c.roishift)
        for res, (pw, ph) in enumerate(c.precincts):
            params[k, 16 + res], params[k, 16 + _MAX_RES + res] = pw, ph
        for b, (e, m) in enumerate(c.steps):
            params[k, 16 + 2 * _MAX_RES + b] = e
            params[k, 16 + 2 * _MAX_RES + _MAX_BANDS + b] = m
    if tc.mct and len(j.comps) >= 3 and len({c.qmfbid for c in tc.comps[:3]}) > 1:
        raise UnsupportedImageError("a JPEG 2000 colour transform over mixed wavelets")
    info = np.array([tx0, ty0, tx1, ty1, len(j.comps), tc.numlayers, tc.mct, tc.csty, len(pocs)],
                    np.int32)
    poc_arr = np.array(pocs, np.int32).reshape(-1)
    body = np.frombuffer(b"".join(tile.parts) + b"\0", np.uint8)
    if j.ppm is not None:  # OpenJPEG reads on through one stream, tile after tile
        packed = j.ppm[ppm_at:]
    elif tile.ppt:
        packed = b"".join(tile.ppt[z] for z in sorted(tile.ppt))
    else:
        packed = None
    if packed is None:
        headers, headers_len = np.zeros(1, np.uint8), -1
    else:
        headers, headers_len = np.frombuffer(packed + b"\0", np.uint8), len(packed)
    used = ctypes.c_int64(0)
    dims = [(-(-ty1 // dy) - -(-ty0 // dy), -(-tx1 // dx) - -(-tx0 // dx))
            for _, _, dx, dy in j.comps]
    out = np.empty(sum(h * w for h, w in dims), np.int32)
    err = ctypes.create_string_buffer(256)
    i32, u8 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    rc = _native().icat_j2k_decode_tile(
        info.ctypes.data_as(i32), poc_arr.ctypes.data_as(i32), params.ctypes.data_as(i32),
        body.ctypes.data_as(u8), len(body) - 1, headers.ctypes.data_as(u8), headers_len,
        ctypes.byref(used), out.ctypes.data_as(i32), err, len(err))
    if rc:
        raise ValueError(err.value.decode())
    planes, at = [], 0
    for h, w in dims:
        planes.append(out[at:at + h * w].reshape(h, w))
        at += h * w
    return planes, used.value


def _color_space(j: Jpeg2000) -> str:
    """The colour space Pillow unpacks by: OpenJPEG's, or where the file
    names none (or one OpenJPEG does not know), sYCC for three or four
    components whose first is full-size and the second or third not, sRGB
    for the other three or four, gray for one or two.  Four components
    named gray unpack as sRGB.  (Held to Pillow over each layout by
    tests/test_torch_jpeg2000.py.)"""
    cs, n = j.color_space, len(j.comps)
    if cs in ("unspecified", "unknown"):
        if n < 3:
            return "gray"
        subsampled = any((dx, dy) != (1, 1) for _, _, dx, dy in j.comps[1:3])
        return "sycc" if j.comps[0][2:] == (1, 1) and subsampled else "srgb"
    return "srgb" if cs == "gray" and n == 4 else cs


# Pillow's unpackers by (mode, colour space, components): the unpacker and
# whether it takes subsampled components
_UNPACKERS = {
    ("L", "gray", 1): ("gray_l", False), ("P", "srgb", 1): ("gray_l", False),
    ("PA", "srgb", 2): ("graya_la", False), ("I;16", "gray", 1): ("gray_i", False),
    ("LA", "gray", 2): ("graya_la", False), ("RGB", "gray", 1): ("gray_rgb", False),
    ("RGB", "gray", 2): ("gray_rgb", False), ("RGB", "srgb", 3): ("srgb_rgb", True),
    ("RGB", "sycc", 3): ("sycc_rgb", True), ("RGB", "srgb", 4): ("srgb_rgb", True),
    ("RGB", "sycc", 4): ("sycc_rgb", True), ("RGBA", "gray", 1): ("gray_rgb", False),
    ("RGBA", "gray", 2): ("graya_la", False), ("RGBA", "srgb", 3): ("srgb_rgb", True),
    ("RGBA", "sycc", 3): ("sycc_rgb", True), ("RGBA", "srgb", 4): ("srgba_rgba", True),
    ("RGBA", "sycc", 4): ("sycca_rgba", True), ("CMYK", "cmyk", 4): ("srgba_rgba", True),
}


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _shifted(words: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` stored into a ``bits``-bit
    sample: 8 (or 16 for ``I;16``) - prec bits of shift, past 8 bits with
    half a step of rounding, in unsigned 32-bit arithmetic, then
    truncated."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (words + offset) & 0xFFFFFFFF
    v = v >> -shift if shift < 0 else (v << shift) & 0xFFFFFFFF
    return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _unpack_tile(j: Jpeg2000, unpacker: str, planes: List[np.ndarray], w: int, h: int):
    """Pillow's ``j2ku_*`` on one tile: OpenJPEG's tile buffer (each
    component's low bytes, one component after another), read with
    Pillow's strides.  Gives (h, w) samples of ``L``/``P``/``I;16`` or
    (h, w, 4) bytes of the other modes.  Where Pillow's floor-divided
    geometry is each component's own, each word is its sample's low
    bytes (each repeated over its subsampling); elsewhere the buffer is
    laid out and read as Pillow reads it, past a component's end too."""
    csizes = [_csiz(p) for p, _, _, _ in j.comps]
    n = {"gray_l": 1, "gray_i": 1, "gray_rgb": 1, "graya_la": 2, "srgba_rgba": 4,
         "sycca_rgba": 4}.get(unpacker, 3)
    subsampled = unpacker not in ("gray_l", "gray_i", "gray_rgb", "graya_la")
    geometry = [(h // dy, w // dx) if subsampled else (h, w) for _, _, dx, dy in j.comps[:n]]
    whole = all(h % dy == 0 and w % dx == 0 for _, _, dx, dy in j.comps[:n]) or not subsampled
    if whole and all(pl.shape == g for pl, g in zip(planes, geometry)):
        def word(k: int) -> np.ndarray:
            v = planes[k].astype(np.int64) & ((1 << (8 * csizes[k])) - 1)
            dx, dy = j.comps[k][2:] if subsampled else (1, 1)
            return v.repeat(dy, 0).repeat(dx, 1) if (dx, dy) != (1, 1) else v
    else:
        chunks = [np.ascontiguousarray(pl.astype("<u4").view(np.uint8).reshape(-1, 4)[:, :cs])
                  for pl, cs in zip(planes, csizes)]
        used = sum(c.size for c in chunks)
        buf = np.zeros(max(used, w * h * sum(csizes)) + 4, np.uint8)
        buf[:used] = np.concatenate([c.ravel() for c in chunks])
        yy, xx = np.mgrid[0:h, 0:w]
        starts, at = [], 0
        for k in range(n):
            starts.append(at)
            gh, gw = geometry[k]
            at += csizes[k] * gh * gw

        def word(k: int) -> np.ndarray:
            dx, dy = j.comps[k][2:] if subsampled else (1, 1)
            index = starts[k] + csizes[k] * ((yy // dy) * geometry[k][1] + xx // dx)
            v = np.zeros((h, w), np.int64)
            for b in range(csizes[k]):
                v |= buf[index + b].astype(np.int64) << (8 * b)
            return v

    def sample(k: int, bits: int = 8) -> np.ndarray:
        return _shifted(word(k), *j.comps[k][:2], bits)

    if unpacker in ("gray_l", "gray_i"):
        return sample(0, 16 if unpacker == "gray_i" else 8)
    out = np.empty((h, w, 4), np.uint8)
    if unpacker in ("gray_rgb", "graya_la"):
        out[..., 0] = out[..., 1] = out[..., 2] = sample(0)
        out[..., 3] = sample(1) if unpacker == "graya_la" else 255
        return out
    for k in range(n):
        out[..., k] = sample(k)
    if n == 3:
        out[..., 3] = 255
    if unpacker.startswith("sycc"):
        y, cb, cr = (out[..., k].astype(np.int64) for k in range(3))
        out[..., 0] = np.clip(y + _YCC[0][cr], 0, 255)
        out[..., 1] = np.clip(y + ((_YCC[2][cb] + _YCC[3][cr]) >> 6), 0, 255)
        out[..., 2] = np.clip(y + _YCC[1][cb], 0, 255)
    return out


def decode_native(data: bytes) -> Tuple[np.ndarray, str]:
    """(H, W, 3) uint8 RGB pixels of a JPEG 2000 file as Pillow's
    ``convert("RGB")`` gives them, by the host C++ decoder, and Pillow's
    mode.  Raises what ``parse`` raises, ``ValueError`` on a broken
    codestream and ``RuntimeError`` where the decoder cannot be built."""
    j = parse(data)
    return _to_rgb(j, _image(j)), j.mode


def _image(j: Jpeg2000) -> np.ndarray:
    """Pillow's image of a parsed file before ``convert``: (H, W) samples
    of ``L``, ``P`` and ``I;16``, (H, W, 4) bytes of the other modes."""
    key = (j.mode, _color_space(j), len(j.comps))
    if key not in _UNPACKERS:
        raise ValueError(f"JPEG 2000 of {len(j.comps)} components in colour space {key[1]} has no "
                         f"unpacker to Pillow's mode {j.mode}")
    unpacker, subsampled = _UNPACKERS[key]
    if not subsampled and any((dx, dy) != (1, 1) for _, _, dx, dy in j.comps):
        raise ValueError(f"JPEG 2000 of Pillow's mode {j.mode} with a subsampled component, "
                         "which Pillow refuses")
    flat = unpacker in ("gray_l", "gray_i")
    img = np.zeros((j.height, j.width) if flat else (j.height, j.width, 4),
                   np.uint16 if unpacker == "gray_i" else np.uint8)
    ppm_at = 0
    for tile in j.tiles:
        tx0, ty0, tx1, ty1 = _tile_bounds(j, tile.index)
        if tx1 - j.x0 > j.width or ty1 - j.y0 > j.height:
            raise ValueError("JPEG 2000 tile lies outside Pillow's image")
        planes, used = decode_tile_native(j, tile, ppm_at)
        ppm_at += used
        img[ty0 - j.y0:ty1 - j.y0, tx0 - j.x0:tx1 - j.x0] = _unpack_tile(
            j, unpacker, planes, tx1 - tx0, ty1 - ty0)
    return img


def _to_rgb(j: Jpeg2000, img: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of the image ``_image`` gives."""
    if j.mode == "L":
        return np.repeat(img[..., None], 3, -1)
    if j.mode == "I;16":
        return np.repeat(np.minimum(img, 255).astype(np.uint8)[..., None], 3, -1)
    if j.mode in ("P", "PA"):
        pal = np.zeros((256, 3), np.uint8)  # black past the palette's colours
        pal[:len(j.palette)] = j.palette[:, :3]
        return pal[img if j.mode == "P" else img[..., 0]]
    if j.mode == "CMYK":  # Convert.c's cmyk2rgb, of samples not inverted as a JPEG's
        return jpeg.cmyk_to_rgb(255 - img)
    return np.ascontiguousarray(img[..., :3])
