"""JPEG without PIL: the bytes of Pillow's baseline ``Image.save(...,
format="JPEG", quality=q)`` in numpy, and the pixels of its ``Image.open``
(and for CMYK its ``convert("RGB")``) in host C++ and numpy, as
libjpeg(-turbo) gives them with its default settings.

Encoder (``encode``):
* quantization: the Annex K tables scaled by IJG's quality rule
  (``jpeg_quality_scaling``), clamped to 255 for baseline;
* colour: fixed-point RGB -> YCbCr (``jccolor.c``, 16 fractional bits);
* 4:2:0 chroma by ``h2v2_downsample``: 2x2 sums plus a rounding bias that
  alternates 1, 2 along each row; rows and columns are repeated out to
  whole blocks as libjpeg's prep and downsample steps repeat them;
* the integer forward DCT ``jfdctint``, then libjpeg-turbo's division by
  8 x Q (a reciprocal multiply, ``compute_reciprocal``); luma blocks of an
  edge MCU that lie past the image are libjpeg's dummy blocks (zero AC, the
  DC of a neighbour);
* Huffman coding with the Annex K tables (``optimize=False``), one
  interleaved scan, no restart markers.  The file is SOI, JFIF APP0, two
  DQT, SOF0, four DHT, SOS, the scan and EOI.

Decoders: ``parse`` reads the markers of a stream of 8-bit samples,
baseline or extended sequential (SOF0, SOF1) of one scan or of several,
progressive (SOF2), arithmetic-coded sequential or progressive (SOF9,
SOF10) or lossless (SOF3): gray, YCbCr, RGB-coded (Adobe transform 0 on
three components, or component ids R, G, B without a JFIF or Adobe
marker; a lossless frame's three components without one, whatever
their ids), CMYK and YCCK (Adobe transform 1 or 2 on four components),
at any sampling factors libjpeg accepts (1 to 4, each component's a
whole fraction of the largest, at most 10 blocks an MCU); each scan's
components, band, successive approximation bits, tables, arithmetic
conditioning (DAC) and restart interval.  It raises
``UnsupportedImageError``, naming the kind, on progressive files that
libjpeg-turbo would smooth (a low coefficient left unsent or unrefined)
and lossless ones of subsampled components; and ``RefusedByPillowError``
on what Pillow refuses too: hierarchical, arithmetic-coded lossless and
12-bit streams, lossless YCbCr, and an arithmetic-coded scan that runs
past the 65,536-byte blocks Pillow feeds libjpeg (``PILLOW_BLOCK``).
``decode_native`` decodes the rest with the host C++ decoder
(``csrc/jpeg.cc``, built with g++ on first use):
every scan into int16 coefficient planes (``jdhuff.c``'s sequential
blocks, ``jdphuff.c``'s DC first and refine, AC first with its end-of-band
runs and AC refine with its correction bits; DC predictors and RSTn
markers; or ``jdarith.c``'s arithmetic decoding of the same passes: the
QM coder of ``QE_TABLE``, statistics per conditioning table, reset at
each restart), dequantization, the integer inverse DCT ``jidctint`` with its
range-limit table, libjpeg-turbo's upsampler of each component
(``jdsample.c``: fancy (triangle) ``h2v1`` and ``h2v2``, box where a
plane is 2 or fewer samples wide; fancy ``h1v2`` (4:4:0); ``int_upsample``
(box) for every other ratio, 4:1:1 among them) with the edge rows and
columns repeated, and fixed-point YCbCr -> RGB (``jdcolor.c``), RGB as
decoded, or for CMYK Pillow's inversion and ``cmyk2rgb``, YCCK first
through ``jdcolor.c``'s YCC -> CMYK: Pillow's pixels, bit for bit.  A
lossless frame's samples come instead from its Huffman-coded differences
and predictors 1-7 (``jdlhuff.c``, ``jdlossls.c``), shifted left by the
point transform.  ``decode`` is its plain numpy version, the same pixels,
whose entropy decoders walk the symbols or decisions in a Python loop,
many times slower (``chip_smoke.py`` phases 21a, 22a and 26c time both).

The DCT, quantization, colour and Huffman-encoding steps are vectorized
over all blocks.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .errors import RefusedByPillowError, UnsupportedImageError

# jpeg_natural_order: zigzag index -> row-major index in the 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                   i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8)))

# ITU-T T.81 Annex K.1, natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# Annex K.3: (code counts by length 1..16, symbols) of the four tables
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {  # (class, id): (counts, symbols); class 0 = DC, 1 = AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA_VALS),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA_VALS),
}

# the integer DCTs' fixed-point constants (13 fractional bits)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantization tables, natural order, of ``quality``
    (``jpeg_set_quality(cinfo, quality, force_baseline=TRUE)``)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int64)
                 for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: np.ndarray, last: bool) -> np.ndarray:
    """One pass of ``jfdctint`` along the last axis (rows, then columns
    with ``last``)."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    shift = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
    out = np.empty_like(d)
    if last:
        out[..., 0] = _descale(t10 + t11, _PASS1_BITS)
        out[..., 4] = _descale(t10 - t11, _PASS1_BITS)
    else:
        out[..., 0] = (t10 + t11) << _PASS1_BITS
        out[..., 4] = (t10 - t11) << _PASS1_BITS
    z1 = (t12 + t13) * _F0_541
    out[..., 2] = _descale(z1 + t13 * _F0_765, shift)
    out[..., 6] = _descale(z1 - t12 * _F1_847, shift)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1_175
    t4, t5, t6, t7 = t4 * _F0_298, t5 * _F2_053, t6 * _F3_072, t7 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    out[..., 7] = _descale(t4 + z1 + z3, shift)
    out[..., 5] = _descale(t5 + z2 + z4, shift)
    out[..., 3] = _descale(t6 + z2 + z3, shift)
    out[..., 1] = _descale(t7 + z1 + z4, shift)
    return out


def fdct(blocks: np.ndarray) -> np.ndarray:
    """``jfdctint`` of (..., 8, 8) level-shifted samples: 8 x the DCT."""
    rows = _fdct_1d(blocks.astype(np.int64), last=False)
    return np.swapaxes(_fdct_1d(np.swapaxes(rows, -1, -2), last=True), -1, -2)


def _reciprocal(divisor: int) -> Tuple[int, int, int]:
    """libjpeg-turbo's ``compute_reciprocal`` for 16-bit DCT elements:
    (reciprocal, correction, shift) with ``q = (|x| + c) * f >> r``."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Quantize (..., 8, 8) ``fdct`` output by a natural-order table, as
    libjpeg-turbo does (divisor 8 x Q, rounding half away from zero)."""
    recips = [_reciprocal(int(q) << 3) for q in table]
    f, c, r = (np.array(v, np.int64).reshape(8, 8) for v in zip(*recips))
    mag = ((np.abs(coefs) + c) * f) >> r
    return np.where(coefs < 0, -mag, mag)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """``jccolor.c``'s fixed-point conversion of uint8 RGB (..., 3)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + offset + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + offset + half - 1) >> 16
    return np.stack([y, cb, cr], -1)


def _repeat_edges(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Extend a 2-D plane to (rows, cols) by repeating its last row and
    column (libjpeg's ``expand_bottom_edge``/``expand_right_edge``)."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def h2v2_downsample(plane: np.ndarray) -> np.ndarray:
    """2x2 box sums of an even-sized plane, plus a bias of 1, 2, 1, 2, ...
    along each output row, shifted right by 2."""
    h, w = plane.shape
    s = plane.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    bias = np.where(np.arange(w // 2) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows/8, cols/8, 8, 8) blocks of a plane."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _huffman_codes(counts, symbols) -> Dict[int, Tuple[int, int]]:
    """symbol -> (code, length) of a table (Annex C)."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _code_arrays(table) -> Tuple[np.ndarray, np.ndarray]:
    codes = _huffman_codes(*table)
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], length[sym] = c, n
    return code, length


def _size(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    while np.any(a >> s):
        s += (a >> s) > 0
    return s


def _magnitude_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << s) - 1, v)


def _mcu_blocks(luma: np.ndarray, cb: np.ndarray, cr: np.ndarray, hb: int, wb: int):
    """Quantized blocks in scan order, (n, 64) zigzag, with each block's
    component: per MCU the 2x2 luma blocks, then Cb, then Cr.  Luma blocks
    past (hb, wb) are libjpeg's dummy blocks: zero AC; at the right edge the
    DC of the block to the left, in a bottom row the DC of the MCU's last
    block of the row above."""
    mr, mc = cb.shape[:2]
    y = np.zeros((2 * mr, 2 * mc, 8, 8), np.int64)
    y[:hb, :wb] = luma[:hb, :wb]
    for c in range(wb, 2 * mc):  # right-edge dummies (c == wb, an odd column)
        y[:hb, c, 0, 0] = y[:hb, c - 1, 0, 0]
    for r in range(hb, 2 * mr):  # bottom dummies (r == hb, an odd row)
        y[r, :, 0, 0] = np.repeat(y[r - 1, 1::2, 0, 0], 2)
    y = y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    mcus = np.concatenate([y, cb.reshape(mr, mc, 1, 64), cr.reshape(mr, mc, 1, 64)], axis=2)
    comps = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
    return mcus.reshape(-1, 64)[:, ZIGZAG], comps


def _scan(blocks: np.ndarray, comps: np.ndarray) -> bytes:
    """The entropy-coded scan: Huffman codes and magnitude bits of every
    block, packed MSB first, padded with 1 bits, 0xFF bytes stuffed."""
    tables = {k: _code_arrays(v) for k, v in STD_HUFFMAN.items()}
    tab = np.minimum(comps, 1)
    n = blocks.shape[0]
    # DC differences within each component
    dc = blocks[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):
        sel = comps == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    items_key, items_val, items_len = [], [], []

    def add(key, sym, tabsel, cls, extra, extra_len):
        code = np.where(tabsel == 0, tables[(cls, 0)][0][sym], tables[(cls, 1)][0][sym])
        length = np.where(tabsel == 0, tables[(cls, 0)][1][sym], tables[(cls, 1)][1][sym])
        items_key.append(key)
        items_val.append((code << extra_len) | extra)
        items_len.append(length + extra_len)

    # items sort by 260 x block + position: the DC at 0, a coefficient at
    # 4 k + 3 after its ZRLs at 4 k + z, the EOB at 259
    s = _size(diff)
    add(np.arange(n) * 260, s, tab, 0, _magnitude_bits(diff, s), s)
    ac = blocks[:, 1:]
    bi, ki = np.nonzero(ac)
    k = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]] if bi.size else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    for z in range(3):  # ZRL (16 zeros) codes before a long run
        sel = run >= 16 * (z + 1)
        add(bi[sel] * 260 + k[sel] * 4 + z, np.full(sel.sum(), 0xF0), tab[bi[sel]], 1,
            np.zeros(sel.sum(), np.int64), np.zeros(sel.sum(), np.int64))
    v = ac[bi, ki]
    s = _size(v)
    add(bi * 260 + k * 4 + 3, ((run % 16) << 4) | s, tab[bi], 1, _magnitude_bits(v, s), s)
    last = np.zeros(n, np.int64)  # each block's last nonzero index
    np.maximum.at(last, bi, k)
    eob = np.nonzero(last < 63)[0]
    add(eob * 260 + 259, np.zeros(eob.size, np.int64), tab[eob], 1,
        np.zeros(eob.size, np.int64), np.zeros(eob.size, np.int64))
    order = np.argsort(np.concatenate(items_key), kind="stable")
    vals = np.concatenate(items_val)[order]
    lens = np.concatenate(items_len)[order]
    total = int(lens.sum())
    item = np.repeat(np.arange(vals.size), lens)
    pos = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (vals[item] >> (lens[item] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def encode(rgb: np.ndarray, quality: int = 75) -> bytes:
    """JPEG bytes of an (H, W, 3) uint8 image, as Pillow's
    ``save(format="JPEG", quality=quality)`` writes them."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8 pixels, not {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    hb, wb = -(-h // 8), -(-w // 8)
    mr, mc = -(-h // 16), -(-w // 16)
    ycc = rgb_to_ycbcr(rgb)
    q_luma, q_chroma = quant_tables(quality)
    luma = _repeat_edges(ycc[..., 0], 16 * mr, 16 * mc)
    luma = quantize(fdct(_blocks(luma) - 128), q_luma)
    chroma = []
    for i in (1, 2):
        full = _repeat_edges(ycc[..., i], h + h % 2, 16 * mc)  # an even row count
        half = _repeat_edges(h2v2_downsample(full), 8 * mr, 8 * mc)
        chroma.append(quantize(fdct(_blocks(half) - 128), q_chroma))
    blocks, comps = _mcu_blocks(luma, chroma[0], chroma[1], hb, wb)
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, table in enumerate((q_luma, q_chroma)):
        out.append(_marker(0xDB, bytes([i]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tab_id in (0, 1):
        for cls in (0, 1):
            counts, symbols = STD_HUFFMAN[(cls, tab_id)]
            out.append(_marker(0xC4, bytes([cls << 4 | tab_id]) + bytes(counts) + symbols))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(_scan(blocks, comps))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _idct_1d(d: np.ndarray, last: bool) -> np.ndarray:
    """One pass of ``jidctint`` along the last axis (columns, then rows
    with ``last``)."""
    z1 = (d[..., 2] + d[..., 6]) * _F0_541
    t2 = z1 - d[..., 6] * _F1_847
    t3 = z1 + d[..., 2] * _F0_765
    t0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    t1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0, t1, t2, t3 = t0 * _F0_298, t1 * _F2_053, t2 * _F3_072, t3 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    shift = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    out = np.empty_like(d)
    for i, v in enumerate((t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                           t13 - t0, t12 - t1, t11 - t2, t10 - t3)):
        out[..., i] = _descale(v, shift)
    return out


# jidctint's output table: index (x & 1023) of a descaled sample x; x in
# [-128, 383] -> clamp(x + 128), beyond that libjpeg's wrap-around
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384, np.int64),
                              np.arange(0, 128)]).astype(np.int64)


def idct(coefs: np.ndarray) -> np.ndarray:
    """``jidctint`` of (..., 8, 8) dequantized coefficients: samples in
    [0, 255].  Its all-zero column and row shortcuts give the same values
    as the full passes, so none is taken here."""
    cols = _idct_1d(np.swapaxes(coefs.astype(np.int64), -1, -2), last=False)
    rows = _idct_1d(np.swapaxes(cols, -1, -2), last=True)
    return _IDCT_LIMIT[rows & 1023]


def h2v1_fancy_upsample(plane: np.ndarray) -> np.ndarray:
    """Double a plane across by the triangle filter of libjpeg's
    ``h2v1_fancy_upsample`` (3/4 of the nearer sample, 1/4 of the further,
    biases 1 and 2), the edge columns repeated; ``h2v1_upsample`` (box)
    where the plane is 2 or fewer columns wide."""
    if plane.shape[1] <= 2:
        return plane.repeat(2, axis=1)
    s = np.pad(plane.astype(np.int64), ((0, 0), (1, 1)), mode="edge")
    left = (3 * s[:, 1:-1] + s[:, :-2] + 1) >> 2
    right = (3 * s[:, 1:-1] + s[:, 2:] + 2) >> 2
    return np.stack([left, right], axis=2).reshape(plane.shape[0], -1)


def h2v2_fancy_upsample(plane: np.ndarray) -> np.ndarray:
    """Double a plane in both directions by the triangle filter of
    libjpeg's ``h2v2_fancy_upsample``, the edge rows and columns repeated;
    ``h2v2_upsample`` (box) where the plane is 2 or fewer columns wide."""
    if plane.shape[1] <= 2:
        return plane.repeat(2, axis=0).repeat(2, axis=1)
    p = np.pad(plane.astype(np.int64), ((1, 1), (0, 0)), mode="edge")
    near = p[1:-1]
    sums = np.stack([3 * near + p[:-2], 3 * near + p[2:]], axis=1)  # (h, 2, w): above, below
    sums = sums.reshape(-1, plane.shape[1])
    s = np.pad(sums, ((0, 0), (1, 1)), mode="edge")
    left = (3 * s[:, 1:-1] + s[:, :-2] + 8) >> 4
    right = (3 * s[:, 1:-1] + s[:, 2:] + 7) >> 4
    return np.stack([left, right], axis=2).reshape(sums.shape[0], -1)


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s fixed-point conversion of (..., 3) YCbCr samples to
    uint8 RGB."""
    y, cb, cr = (ycc[..., i].astype(np.int64) - (0 if i == 0 else 128) for i in range(3))
    half = 1 << 15
    r = y + ((_fix16(1.402) * cr + half) >> 16)
    g = y + ((-_fix16(0.34414) * cb + half - _fix16(0.71414) * cr) >> 16)
    b = y + ((_fix16(1.772) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# the frame markers read here: (progressive, arithmetic-coded, lossless)
_FRAMES = {0xC0: (False, False, False), 0xC1: (False, False, False),
           0xC2: (True, False, False), 0xC3: (False, False, True),
           0xC9: (False, True, False), 0xCA: (True, True, False)}
# the others, by what they code: libjpeg-turbo refuses them, and Pillow raises
_FRAME_KINDS = {
    0xC5: "hierarchical sequential", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical sequential",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
}
# an arithmetic-coded frame's conditioning (DAC) before any DAC segment, per
# table: DC bounds L and U, AC Kx (jdmarker.c's get_soi)
_DAC_DEFAULT = (0, 1, 5)
# the bytes Pillow's ImageFile.load reads at a time (ImageFile.MAXBLOCK)
PILLOW_BLOCK = 65536
_ARITH_TABLES = 16  # NUM_ARITH_TBLS
# libjpeg's most blocks in an MCU of an interleaved scan (D_MAX_BLOCKS_IN_MCU)
_MAX_BLOCKS_IN_MCU = 10
# what each colour space's samples are decoded into (jdcolor.c), by the
# code csrc/jpeg.cc takes
COLOURS = {"gray": 0, "ycc": 1, "rgb": 2, "cmyk": 3, "ycck": 4}
# the low zigzag coefficients whose precision libjpeg-turbo's block smoothing
# (jdcoefct.c, SAVED_COEFS) checks after the last scan of a progressive file
_SMOOTHED_COEFS = 10

# jaricom.c's jpeg_aritab (ITU-T T.81 Table D.2): per state of a statistics
# bin, (Qe, the state after an LPS, after an MPS, whether an LPS switches
# the MPS); the last, 113, is the fixed one-half estimate that sign and
# refinement bits are coded with (T.851 Table 5)
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
FIXED_BIN = 113
# Table F.4 and F.5's bins: a DC table's 64 (contexts S0 at 0, 4, 8, 12, 16;
# the categories X1.. at 20; their bits M at X + 14), an AC table's 256 (S0
# of coefficient k at 3 (k - 1); the categories past the second at 189 up
# to coefficient Kx, at 217 after it)
_DC_BINS, _AC_BINS, _DC_X1, _AC_X_LOW, _AC_X_HIGH = 64, 256, 20, 189, 217

Table = Tuple[Tuple[int, ...], bytes]  # (code counts by length 1..16, symbols)


@dataclasses.dataclass
class Scan:
    """One scan: its components (indices into the frame's, in frame
    order), spectral band ``ss``..``se`` (zigzag) and successive
    approximation bits ``ah``, ``al`` (in a lossless frame ``ss`` is the
    predictor, ``al`` the point transform); per component the DC and AC
    Huffman tables it reads (None where it reads none); the restart
    interval in its units (MCUs, or blocks in a scan of one component, or
    samples in a lossless frame; 0: none); its entropy-coded bytes, RSTn
    markers included; whether a marker ends it, or the file does; in an
    arithmetic-coded frame, per component its DC and AC conditioning
    tables and their values: (DC table, AC table, L, U, Kx)."""

    comps: List[int]
    ss: int
    se: int
    ah: int
    al: int
    dc: List[Optional[Table]]
    ac: List[Optional[Table]]
    restart: int
    coded: bytes
    ended: bool
    conditioning: List[Tuple[int, int, int, int, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Frame:
    """What the decoders need of a stream: the size; per component its
    sampling factors (h, v) and its quantization table (64, natural order,
    as it stood at the component's first scan); Pillow's mode (``L``,
    ``RGB`` for YCbCr and RGB-coded, ``CMYK`` for CMYK and YCCK); whether
    it is progressive; its scans; the colour space libjpeg takes it as
    (a key of ``COLOURS``); whether it is arithmetic-coded, or lossless
    (its components' samples coded as differences from a prediction, no
    DCT)."""

    height: int
    width: int
    sampling: List[Tuple[int, int]]
    quant: List[np.ndarray]
    mode: str
    progressive: bool
    scans: List[Scan]
    colour: str = "ycc"
    arithmetic: bool = False
    lossless: bool = False


def _colour(ids: List[int], jfif: bool, adobe: Optional[int], lossless: bool = False) -> str:
    """The colour space libjpeg takes a frame of these components as
    (``default_decompress_parms``): three are YCbCr after a JFIF marker,
    RGB with Adobe transform 0 (YCbCr with any other), else RGB where the
    ids are R, G, B, and in a lossless frame whatever the ids (libjpeg-turbo
    3's "assuming YCbCr (lossy) or RGB (lossless)"); four are CMYK without
    an Adobe marker or with its transform 0, YCCK with any other."""
    if len(ids) == 1:
        return "gray"
    if len(ids) == 3:
        if jfif:
            return "ycc"
        if adobe is not None:
            return "rgb" if adobe == 0 else "ycc"
        return "rgb" if lossless or ids == [82, 71, 66] else "ycc"
    return "cmyk" if adobe in (None, 0) else "ycck"


def _check_sampling(sampling: List[Tuple[int, int]]) -> None:
    """Raise where libjpeg refuses the frame's sampling factors: outside 1
    to 4, or a component's not a whole fraction of the largest
    (``jdsample.c``'s ``JERR_FRACT_SAMPLE_NOTIMPL``)."""
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    for hs, vs in sampling:
        if not (1 <= hs <= 4 and 1 <= vs <= 4):
            raise ValueError(f"JPEG sampling factors {hs}x{vs} are not 1 to 4")
        if hmax % hs or vmax % vs:
            raise ValueError(f"JPEG sampling factors {['%dx%d' % s for s in sampling]}: "
                             "libjpeg does not upsample by a fraction")


def _corrupt_scan(what: str) -> UnsupportedImageError:
    """The error for a fault inside a scan that a marker ends: libjpeg
    decodes such a scan with a warning (zeros past a bad code, a resync at
    a lost RSTn), and Pillow gives its pixels."""
    return UnsupportedImageError(f"corrupt JPEG scan ({what}): libjpeg decodes it with a "
                                 "warning, this reader does not")


# scan faults where the bytes ran out: with no marker after the scan, libjpeg
# on Pillow's suspending source waits for bytes that never come, and Pillow
# raises that the file is truncated
_RAN_OUT = ("ends early", "no RST marker where a restart interval ends")


def _scan_fault(scan: Scan, what: str) -> ValueError:
    """The error for a fault in ``scan``: a plain ``ValueError`` where the
    file was cut inside it, as Pillow raises, else ``_corrupt_scan``."""
    if not scan.ended and what in _RAN_OUT:
        return ValueError(f"JPEG stream is truncated: its scan {what}")
    return _corrupt_scan(what)


def _check_ended(f: Frame) -> None:
    """Raise on a last scan that decodes whole with no marker after it:
    Pillow reads such a file or calls it truncated as libjpeg's input
    buffer falls, so this reader takes neither course."""
    if not f.scans[-1].ended:
        raise UnsupportedImageError("JPEGs with no marker (EOI) after their scan are not "
                                    "supported: Pillow reads them or calls them truncated, as "
                                    "libjpeg's input buffer falls")


def _check_restarts(coded: bytes, n: int) -> None:
    """Raise unless the scan's first ``n`` RSTn markers are there and
    numbered 0, 1, ..., 7, 0, ... as the restart intervals need."""
    raw = np.frombuffer(coded, np.uint8)
    at = np.nonzero((raw[:-1] == 0xFF) & (raw[1:] >= 0xD0) & (raw[1:] <= 0xD7))[0]
    if at.size < n:
        raise _corrupt_scan(f"{at.size} RST markers where its restart intervals need {n}")
    got = raw[at[:n] + 1] - 0xD0
    bad = np.nonzero(got != np.arange(n) % 8)[0]
    if bad.size:
        raise _corrupt_scan(f"RST{got[bad[0]]} where RST{bad[0] % 8} belongs")


def _scan_end(data: bytes, pos: int) -> int:
    """The offset of the marker that ends the scan starting at ``pos``: the
    first 0xFF followed by neither 0x00 (a stuffed byte), 0xFF (fill) nor
    RST0-7 (which stay inside the scan)."""
    raw = np.frombuffer(data, np.uint8)[pos:]
    nxt = raw[1:]
    hits = np.nonzero((raw[:-1] == 0xFF) & (nxt != 0) & (nxt != 0xFF)
                      & ((nxt < 0xD0) | (nxt > 0xD7)))[0]
    return pos + int(hits[0]) if hits.size else len(data)


def _geometry(f: Frame) -> Tuple[int, int, int, int]:
    """(hmax, vmax, MCUs across, MCUs down) of a frame."""
    hmax = max(s[0] for s in f.sampling)
    vmax = max(s[1] for s in f.sampling)
    return hmax, vmax, -(-f.width // (8 * hmax)), -(-f.height // (8 * vmax))


def _grid(f: Frame, k: int) -> Tuple[int, int]:
    """(blocks down, blocks across) that a scan of component ``k`` alone
    codes: its own samples' blocks, not the MCU-padded plane's."""
    hmax, vmax, _, _ = _geometry(f)
    hs, vs = f.sampling[k]
    return -(-(-(-f.height * vs // vmax)) // 8), -(-(-(-f.width * hs // hmax)) // 8)


def _units(f: Frame, scan: Scan) -> int:
    """The units a scan codes: its MCUs, or its one component's blocks; in
    a lossless frame (every component at 1x1) its samples."""
    if f.lossless:
        return f.width * f.height
    if len(scan.comps) == 1:
        gh, gw = _grid(f, scan.comps[0])
        return gh * gw
    _, _, mcux, mcuy = _geometry(f)
    return mcux * mcuy


def _check_table(table: Table, dc: bool, largest: int = 15) -> Table:
    """Raise where libjpeg's ``jpeg_make_d_derived_tbl`` refuses a table:
    up to its longest codes, more codes of a length than the shorter ones
    leave room for beside the all-ones code, which none may be; or a DC
    symbol above ``largest`` (15; a lossless difference's 16)."""
    code = 0
    longest = max((i for i, n in enumerate(table[0], start=1) if n), default=0)
    for length, n in enumerate(table[0][:longest], start=1):
        code += n
        if code >= 1 << length:
            raise ValueError("JPEG Huffman table: more codes than its lengths hold")
        code <<= 1
    if dc and any(s > largest for s in table[1]):
        raise ValueError(f"JPEG DC Huffman table has a symbol above {largest}")
    return table


def _scan_problem(progressive: bool, n: int, ss: int, se: int, ah: int, al: int) -> Optional[str]:
    """What libjpeg refuses in a scan header (``jdphuff.c``'s
    ``JERR_BAD_PROGRESSION``; a sequential scan's band and bits only warn),
    else None."""
    if not progressive:
        return None
    if (ss == 0 and se != 0) or (ss > 0 and (ss > se or se > 63 or n != 1)):
        return f"band {ss}..{se} over {n} components"
    if (ah and al != ah - 1) or al > 13:
        return f"successive approximation bits {ah}, {al}"
    return None


def parse(data: bytes, tables: bytes = b"", blocks: bool = True) -> Frame:
    """The frame, tables and scans of a JPEG of 8-bit samples: baseline or
    extended sequential (SOF0, SOF1) of one scan or several, progressive
    (SOF2), arithmetic-coded sequential or progressive (SOF9, SOF10, with
    the DAC segments' conditioning), or lossless (SOF3, Huffman); gray,
    YCbCr, RGB-coded, CMYK or YCCK at any sampling libjpeg accepts
    (``ValueError`` on another; a lossless frame's components all at 1x1,
    in a colour space it needs no conversion from).  Raises
    ``UnsupportedImageError`` naming any other kind (a lossless one of
    subsampled components; its subclass ``RefusedByPillowError`` where
    Pillow refuses the kind too: hierarchical, arithmetic-coded lossless,
    12-bit, lossless YCbCr or YCCK), a
    progression libjpeg decodes with a warning, a progressive file whose
    scans leave one of the low coefficients libjpeg-turbo's block smoothing
    checks unsent or unrefined, a component no scan codes, or a corrupt
    scan that a marker ends (RSTn markers missing or misnumbered); and
    ``ValueError`` on a broken stream, or a multi-scan one that ends
    before EOI (libjpeg reads such a file to its EOI before its first row,
    so Pillow calls it truncated).  Extraneous bytes before a marker are
    skipped, as Pillow and libjpeg skip them.  The decoders raise
    ``_scan_fault``'s errors on a fault inside a scan, and
    ``_check_ended``'s on a single scan no marker ends.

    ``tables``, where given, is an abbreviated table stream (SOI, DQT and
    DHT segments, EOI), as a JPEG-compressed TIFF's ``JPEGTables`` field
    holds: libjpeg loads its tables before it reads ``data``, an
    abbreviated image stream, which may redefine them.

    ``blocks``: the stream is a file that Pillow hands libjpeg in blocks
    of ``PILLOW_BLOCK`` bytes, as its JPEG reader does (libtiff hands it a
    whole strip).  libjpeg's marker reader waits for the next block where
    a segment runs past the last, but its arithmetic decoder cannot wait:
    an arithmetic-coded scan whose bytes, with the marker after them, run
    past the blocks its segments were read from makes Pillow raise, and
    raises ``RefusedByPillowError`` naming it here."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError("not a JPEG stream (no SOI marker and marker after it)")
    if tables:
        if tables[:2] != b"\xff\xd8":
            raise ValueError("JPEG table stream has no SOI marker")
        body = tables[2:-2] if tables.endswith(b"\xff\xd9") else tables[2:]
        data = data[:2] + body + data[2:]
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Table] = {}
    frame, restart, jfif, adobe = None, 0, False, None
    dac = [list(_DAC_DEFAULT) for _ in range(_ARITH_TABLES)]
    scans: List[Scan] = []
    quant: Dict[int, np.ndarray] = {}
    progression: List[List[int]] = []  # per component, each coefficient's Al (-1: unsent)
    bogus = None
    eoi = False
    pos = 2
    held = PILLOW_BLOCK if blocks else len(data) + 2  # the bytes libjpeg has been handed
    while True:
        if pos + 2 > len(data):
            if scans:
                break
            raise ValueError("JPEG stream ends before its scan")
        if data[pos] != 0xFF:  # extraneous bytes before a marker: skipped
            pos += 1
            continue
        code = data[pos + 1]
        if code in (0x00, 0xFF):  # an escaped 0xFF (skipped) or a fill byte
            pos += 2 if code == 0x00 else 1
            continue
        if code < 0xC0:
            raise ValueError(f"JPEG stream: no marker at byte {pos} (0xFF{code:02X})")
        if code == 0xD9:
            if not scans:
                raise ValueError("JPEG stream ends before its scan")
            eoi = True
            break
        if 0xD0 <= code <= 0xD8:  # markers without a body
            pos += 2
            continue
        if pos + 4 > len(data):
            if scans:
                break
            raise ValueError("JPEG stream ends before its scan")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            if scans:
                break
            raise ValueError(f"JPEG marker 0x{code:02X} is truncated")
        pos += 2 + length
        held = max(held, -(-pos // PILLOW_BLOCK) * PILLOW_BLOCK)
        if code == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif code == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif code == 0xDB:
            i = 0
            while i < len(body):
                wide, tid = body[i] >> 4, body[i] & 15
                n = 128 if wide else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if wide else np.uint8)
                if vals.size != 64:
                    raise ValueError("JPEG quantization table is truncated")
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = vals
                qt[tid] = nat
                i += 1 + n
        elif code == 0xC4:
            i = 0
            while i < len(body):
                counts = tuple(body[i + 1:i + 17])
                n = sum(counts)
                if len(counts) != 16 or n > 256 or i + 17 + n > len(body):
                    raise ValueError("JPEG Huffman table is malformed")
                huff[(body[i] >> 4, body[i] & 15)] = (counts, bytes(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif code == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif code == 0xCC:  # DAC: (class << 4 | table, value) pairs
            for i in range(0, len(body) - 1, 2):
                index, value = body[i], body[i + 1]
                if index >= 2 * _ARITH_TABLES:
                    raise ValueError(f"JPEG DAC segment defines table {index}")
                if index >= _ARITH_TABLES:
                    dac[index - _ARITH_TABLES][2] = value
                elif value & 15 > value >> 4:
                    raise ValueError(f"JPEG DAC segment: DC bounds L {value & 15} > U "
                                     f"{value >> 4}")
                else:
                    dac[index][:2] = [value & 15, value >> 4]
        elif code in _FRAME_KINDS:
            raise RefusedByPillowError(f"{_FRAME_KINDS[code]} JPEGs are not supported: frame "
                                       f"type 0x{code:02X}, which libjpeg-turbo and Pillow "
                                       "refuse too")
        elif code in _FRAMES:
            if frame is not None:
                raise ValueError("JPEG stream has two frames")
            precision, h, w, ncomp = struct.unpack(">BHHB", body[:6])
            comps = [tuple(body[6 + 3 * k:9 + 3 * k]) for k in range(ncomp)]
            if precision != 8:
                raise RefusedByPillowError(f"{precision}-bit JPEGs are not supported (8-bit only, "
                                           "as Pillow)")
            if ncomp not in (1, 3, 4) or len(comps[-1]) != 3:
                raise UnsupportedImageError(f"{ncomp}-component JPEGs are not supported")
            if h == 0 or w == 0:
                raise UnsupportedImageError("JPEGs whose height comes after the scan (DNL) are "
                                            "not supported")
            sampling = [(c[1] >> 4, c[1] & 15) for c in comps]
            _check_sampling(sampling)
            if ncomp == 1:
                sampling = [(1, 1)]  # one component: one block an MCU
            progressive, arithmetic, lossless = _FRAMES[code]
            if lossless and any(sm != (1, 1) for sm in sampling):
                raise UnsupportedImageError(f"lossless JPEGs of subsampled components "
                                            f"({['%dx%d' % sm for sm in sampling]}) are not "
                                            "supported")
            frame = Frame(h, w, sampling, [], "", progressive, scans, arithmetic=arithmetic,
                          lossless=lossless)
            ids, qsel = [c[0] for c in comps], [c[2] for c in comps]
            progression = [[-1] * 64 for _ in comps]
        elif code == 0xDA:
            if frame is None:
                raise ValueError("JPEG stream has no frame (SOF0-3, SOF9, SOF10) before its scan")
            if not scans:
                frame.colour = _colour(ids, jfif, adobe, frame.lossless)
                frame.mode = {"gray": "L", "ycc": "RGB", "rgb": "RGB"}.get(frame.colour, "CMYK")
                if frame.lossless and frame.colour in ("ycc", "ycck"):
                    raise RefusedByPillowError(
                        f"lossless JPEGs in {'YCbCr' if frame.colour == 'ycc' else 'YCCK'} are "
                        "not supported: libjpeg-turbo converts no lossless frame's colour, and "
                        "Pillow raises too")
            n = body[0] if body else 0
            if not 1 <= n <= len(ids) or len(body) != 4 + 2 * n:
                raise ValueError(f"JPEG scan header of {len(body)} bytes codes {n} components")
            sel = [(body[1 + 2 * j], body[2 + 2 * j]) for j in range(n)]
            if any(c not in ids for c, _ in sel):
                raise ValueError("JPEG scan codes a component the frame does not have")
            members = [ids.index(c) for c, _ in sel]
            if members != sorted(set(members)):
                raise ValueError("JPEG scan codes its components in another order than the "
                                 "frame's")
            if n > 1 and sum(frame.sampling[k][0] * frame.sampling[k][1]
                             for k in members) > _MAX_BLOCKS_IN_MCU:
                raise ValueError(f"JPEG scan of more than {_MAX_BLOCKS_IN_MCU} blocks an MCU")
            ss, se, ah, al = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n] >> 4, \
                body[3 + 2 * n] & 15
            if frame.lossless:
                if not 1 <= ss <= 7 or se or ah or al > 7:
                    raise ValueError(f"JPEG lossless scan is invalid: predictor {ss}, Se {se}, "
                                     f"Ah {ah}, point transform {al}")
                if restart % frame.width:
                    raise ValueError(f"JPEG lossless restart interval of {restart} samples is "
                                     f"not whole rows of {frame.width}")
            problem = None if frame.lossless else _scan_problem(frame.progressive, n, ss, se,
                                                                 ah, al)
            if problem:
                raise ValueError(f"JPEG progression is invalid: a scan of {problem}")
            if not frame.progressive and not frame.lossless and (ss, se, ah, al) != (0, 63, 0, 0):
                bogus = bogus or f"a sequential scan of band {ss}..{se}, bits {ah}, {al}"
            for k in members if not frame.lossless else ():
                bits = progression[k]
                if ss > 0 and bits[0] < 0:
                    bogus = bogus or f"AC before DC in component {k}"
                if any(max(b, 0) != ah for b in bits[ss:se + 1]):
                    bogus = bogus or f"bits {ah}, {al} over {ss}..{se} in component {k}"
                bits[ss:se + 1] = [al] * (se - ss + 1)
            dc, ac, conditioning = [None] * n, [None] * n, []
            try:
                for k in members:
                    quant.setdefault(k, np.zeros(64, np.int64) if frame.lossless
                                     else qt[qsel[k]])
                if frame.arithmetic:
                    conditioning = [(t >> 4, t & 15, *dac[t >> 4][:2], dac[t & 15][2])
                                    for _, t in sel]
                elif frame.lossless:
                    dc = [_check_table(huff[(0, t >> 4)], True, largest=16) for _, t in sel]
                else:
                    dc = [_check_table(huff[(0, t >> 4)], True)
                          if ss == 0 and (ah == 0 or not frame.progressive) else None
                          for _, t in sel]
                    ac = [_check_table(huff[(1, t & 15)], False)
                          if se > 0 else None for _, t in sel]
            except KeyError as e:
                raise ValueError(f"JPEG scan uses a table the stream does not define: {e}") \
                    from None
            end = _scan_end(data, pos)
            if frame.arithmetic and end < len(data) and end + 2 > held:
                raise RefusedByPillowError(
                    f"arithmetic-coded JPEGs whose scan runs past byte {held} are not "
                    f"supported: Pillow hands libjpeg {PILLOW_BLOCK}-byte blocks, whose "
                    "arithmetic decoder cannot wait for the next, and Pillow raises")
            scan = Scan(members, ss, se, ah, al, dc, ac, restart, data[pos:end], end < len(data),
                        conditioning)
            scans.append(scan)
            if restart and scan.ended:
                _check_restarts(scan.coded, -(-_units(frame, scan) // restart) - 1)
            pos = end
            if len(scans) == 1 and n == len(ids) and not frame.progressive:
                # one interleaved scan (sequential or lossless): libjpeg decodes it in one pass, then
                # reads the markers after it to EOI
                if scan.ended:
                    _check_trailer(data, end)
                break
    buffered = len(scans) > 1 or frame.progressive or len(scans[0].comps) < len(ids)
    if buffered and not eoi:
        raise ValueError("JPEG stream is truncated: it ends before the EOI marker that "
                         "libjpeg reads a multi-scan file to")
    if bogus:
        raise UnsupportedImageError(f"JPEG progression libjpeg decodes with a warning "
                                    f"({bogus}) is not supported")
    if buffered:
        missing = sorted(set(range(len(ids))) - set(quant))
        if missing:
            raise UnsupportedImageError(f"JPEGs with a component no scan codes ({missing}) are "
                                        "not supported")
        if frame.progressive and any(b != 0 for bits in progression
                                     for b in bits[:_SMOOTHED_COEFS]):
            raise UnsupportedImageError(
                "incomplete progressive JPEGs are not supported: their scans leave one of "
                f"the first {_SMOOTHED_COEFS} coefficients unsent or unrefined, and "
                "libjpeg-turbo smooths such blocks")
    frame.quant = [quant[k] for k in range(len(ids))]
    return frame


# the markers libjpeg skips after a one-pass file's scan: DHT, DAC, DQT,
# DNL, DRI, APPn, COM, each with a length
_SKIPPED_AFTER_SCAN = {0xC4, 0xCC, 0xDB, 0xDC, 0xDD, *range(0xE0, 0xF0), 0xFE}


def _check_trailer(data: bytes, pos: int) -> None:
    """Raise where libjpeg's ``jpeg_finish_decompress`` of a one-pass file
    (one interleaved sequential scan) errs on the markers after its scan,
    which it reads to EOI: another scan (``JERR_EOI_EXPECTED``), SOI, a
    frame, or a marker it does not know; or a Huffman table it refuses.
    Stray bytes, RSTn and TEM are skipped, as are tables, APPn and COM
    segments; where the data ends first, libjpeg suspends and Pillow keeps
    the rows."""
    while pos + 1 < len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF):
            pos += 1
            continue
        code = data[pos + 1]
        if code == 0xD9:
            return
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            pos += 2
            continue
        if code not in _SKIPPED_AFTER_SCAN:
            what = "a second scan" if code == 0xDA else f"marker 0x{code:02X}"
            raise ValueError(f"JPEG stream: {what} after the scan of every component, where "
                             "libjpeg expects EOI")
        if pos + 4 > len(data):
            return
        length = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + length]
        if len(body) < length - 2:
            return
        if code == 0xC4:
            i = 0
            while length - 2 - i > 16:
                counts = body[i + 1:i + 17]
                if body[i] & 0x0F > 3 or sum(counts) > min(256, len(body) - i - 17):
                    raise ValueError("JPEG Huffman table after the scan is malformed")
                i += 17 + sum(counts)
            if i != length - 2:
                raise ValueError("JPEG Huffman table after the scan has a bad length")
        pos += 2 + length


def _decode_tables(counts, symbols) -> Tuple[List[int], List[int]]:
    """(symbol, code length) of every 16-bit window whose leading bits are
    a code of the table (length 0: no code)."""
    sym, length = np.zeros(1 << 16, np.int64), np.zeros(1 << 16, np.int64)
    for s, (code, n) in _huffman_codes(counts, symbols).items():
        lo = code << (16 - n)
        sym[lo:lo + (1 << (16 - n))] = s
        length[lo:lo + (1 << (16 - n))] = n
    return sym.tolist(), length.tolist()


def h1v2_fancy_upsample(plane: np.ndarray) -> np.ndarray:
    """Double a plane down by libjpeg-turbo's ``h1v2_fancy_upsample``: 3/4
    of the nearer row and 1/4 of the one above (bias 1) or below (bias 2),
    the edge rows repeated."""
    p = np.pad(plane.astype(np.int64), ((1, 1), (0, 0)), mode="edge")
    near = 3 * p[1:-1]
    rows = np.stack([(near + p[:-2] + 1) >> 2, (near + p[2:] + 2) >> 2], axis=1)
    return rows.reshape(-1, plane.shape[1])


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """A plane at the frame's largest sampling, by the upsampler
    libjpeg-turbo's ``jinit_upsampler`` picks for the ratio (fx, fy)."""
    if (fx, fy) == (1, 1):
        return plane
    if (fx, fy) == (2, 1):
        return h2v1_fancy_upsample(plane)
    if (fx, fy) == (1, 2):
        return h1v2_fancy_upsample(plane)
    if (fx, fy) == (2, 2):
        return h2v2_fancy_upsample(plane)
    return plane.repeat(fy, axis=0).repeat(fx, axis=1)  # int_upsample


def cmyk_to_rgb(samples: np.ndarray) -> np.ndarray:
    """Pillow's RGB of a CMYK JPEG's decoded (..., 4) samples: its
    ``CMYK;I`` raw mode inverts them (Adobe's convention), then
    ``Convert.c``'s ``cmyk2rgb`` takes each of C, M, Y times 255 - K
    (``MULDIV255``) from 255 - K."""
    cmyk = 255 - samples.astype(np.int64)
    nk = 255 - cmyk[..., 3:]
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of a YCbCr, RGB, CMYK or YCCK JPEG, (H, W,
    1) of a gray one, as Pillow gives them from libjpeg with its defaults
    (islow IDCT, fancy upsampling; CMYK and YCCK through Pillow's
    conversion): the plain
    numpy version of ``decode_native`` (a Python loop over the Huffman
    symbols, many times slower)."""
    return decode_frame(parse(data))


def decode_frame(f: Frame) -> np.ndarray:
    """``decode`` of a parsed stream."""
    hmax, vmax, _, _ = _geometry(f)
    planes = []
    for k, zz in enumerate(_lossless_planes(f) if f.lossless else _coefficients(f)):
        if f.lossless:
            planes.append(zz)
            continue
        hs, vs = f.sampling[k]
        nat = np.zeros_like(zz)
        nat[..., ZIGZAG] = zz * f.quant[k][ZIGZAG]
        samples = idct(nat.reshape(*nat.shape[:2], 8, 8))
        plane = samples.transpose(0, 2, 1, 3).reshape(8 * zz.shape[0], 8 * zz.shape[1])
        plane = plane[:-(-f.height * vs // vmax), :-(-f.width * hs // hmax)]
        planes.append(_upsample(plane, hmax // hs, vmax // vs)[:f.height, :f.width])
    _check_ended(f)
    if f.colour == "gray":
        return planes[0][..., None].astype(np.uint8)
    if f.colour == "rgb":
        return np.stack(planes, -1).astype(np.uint8)
    if f.colour == "ycck":  # jdcolor.c's ycck_cmyk_convert: CMY = 255 - the YCbCr's RGB
        cmy = 255 - ycbcr_to_rgb(np.stack(planes[:3], -1)).astype(np.int64)
        return cmyk_to_rgb(np.concatenate([cmy, planes[3][..., None]], -1))
    if f.colour == "cmyk":
        return cmyk_to_rgb(np.stack(planes, -1))
    return ycbcr_to_rgb(np.stack(planes, -1))


def _restart_intervals(coded: bytes) -> List[bytes]:
    """The entropy-coded bytes between RSTn markers (fill bytes dropped)."""
    raw = np.frombuffer(coded, np.uint8)
    at = np.nonzero((raw[:-1] == 0xFF) & (raw[1:] >= 0xD0) & (raw[1:] <= 0xD7))[0]
    bounds = [0, *(int(i) + 2 for i in at)]
    ends = [*(int(i) for i in at), len(coded)]
    return [coded[a:b].rstrip(b"\xff") for a, b in zip(bounds, ends)]


# the most bits one block's codes take: 64 codes of 16 bits, each with 11
# magnitude bits
_BLOCK_BITS = 64 * 27


def _bit_windows(interval: bytes) -> Tuple[List[int], int]:
    """The 16-bit window at each bit of a restart interval's bytes (byte
    stuffing undone), zeros past its end for as far as one block's codes
    may reach, and its count of bits."""
    raw = np.frombuffer(interval, np.uint8)
    keep = np.ones(raw.size, bool)
    keep[1:] &= ~((raw[:-1] == 0xFF) & (raw[1:] == 0))  # byte stuffing
    bits = np.unpackbits(raw[keep]).astype(np.int64)
    nbits = bits.size
    bits = np.concatenate([bits, np.zeros(_BLOCK_BITS + 16, np.int64)])
    window = np.zeros(nbits + _BLOCK_BITS, np.int64)
    for i in range(16):
        window = (window << 1) | bits[i:i + nbits + _BLOCK_BITS]
    return window.tolist(), nbits


def _i16(v: int) -> int:
    """``v`` stored in a JCOEF (int16), as libjpeg stores coefficients."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _coefficients(f: Frame) -> List[np.ndarray]:
    """Zigzag coefficients of every block of each component, (blocks down,
    blocks across, 64) over its MCU-padded plane, after every scan."""
    _, _, mcux, mcuy = _geometry(f)
    shapes = [(mcuy * vs, mcux * hs) for hs, vs in f.sampling]
    coefs = [[0] * (64 * a * b) for a, b in shapes]
    for scan in f.scans:
        (_decode_arith_scan if f.arithmetic else _decode_scan)(f, scan, coefs, shapes)
    return [np.array(c, np.int64).reshape(*shape, 64) for c, shape in zip(coefs, shapes)]


def _unit_blocks(f: Frame, scan: Scan, shapes):
    """The function of a unit's index that gives its blocks: (slot in the
    scan, component, offset of the block's 64 in that component's
    coefficients) per block, an MCU's each component's hs x vs blocks in
    raster order, or the one block of a scan of one component, over that
    component's own grid."""
    _, _, mcux, _ = _geometry(f)
    if len(scan.comps) == 1:
        k = scan.comps[0]
        gw, bw = _grid(f, k)[1], shapes[k][1]
        return lambda u: ((0, k, 64 * ((u // gw) * bw + u % gw)),)
    plan = [(j, k, v, u) for j, k in enumerate(scan.comps)
            for v in range(f.sampling[k][1]) for u in range(f.sampling[k][0])]

    def blocks(m):
        my, mx = divmod(m, mcux)
        return [(j, k, 64 * ((my * f.sampling[k][1] + v) * shapes[k][1]
                             + mx * f.sampling[k][0] + u)) for j, k, v, u in plan]
    return blocks


def _scan_pass(f: Frame, scan: Scan) -> str:
    """What a DCT scan codes: sequential blocks, or a progressive scan's DC
    first or refine, AC first or refine."""
    if not f.progressive:
        return "sequential"
    if scan.ss == 0:
        return "dc refine" if scan.ah else "dc first"
    return "ac refine" if scan.ah else "ac first"


def _decode_scan(f: Frame, scan: Scan, coefs: List[List[int]], shapes) -> None:
    """Decode one scan into ``coefs``, as libjpeg's ``jdhuff.c``
    (sequential) and ``jdphuff.c`` (progressive: DC first and refine, AC
    first with its end-of-band runs, AC refine with its correction bits)
    do: per unit (an MCU, each of its components' hs x vs blocks in raster
    order; or one block of the scan's one component, over that
    component's own grid) every block; the DC predictors and the
    end-of-band run start at 0 in each restart interval."""
    n_units = _units(f, scan)
    blocks = _unit_blocks(f, scan, shapes)
    kind = _scan_pass(f, scan)
    ss, se, al = scan.ss, scan.se, scan.al
    p1, m1 = 1 << al, -1 << al
    per_interval = scan.restart or n_units
    intervals = _restart_intervals(scan.coded)
    if len(intervals) < -(-n_units // per_interval):
        raise _scan_fault(scan, "no RST marker where a restart interval ends")
    dc_tabs = [_decode_tables(*t) if t else None for t in scan.dc]
    ac_tabs = [_decode_tables(*t) if t else None for t in scan.ac]
    for first in range(0, n_units, per_interval):
        win, nbits = _bit_windows(intervals[first // per_interval])
        pred = [0] * len(scan.comps)
        eobrun = 0
        p = 0
        for unit in range(first, min(first + per_interval, n_units)):
            for j, k, base in blocks(unit):
                blk = coefs[k]
                if kind in ("sequential", "dc first"):
                    dsym, dlen = dc_tabs[j]
                    w = win[p]
                    s = dsym[w]
                    if not dlen[w]:
                        raise _scan_fault(scan, "bad DC code")
                    p += dlen[w]
                    diff = 0
                    if s:
                        diff = win[p] >> (16 - s)
                        p += s
                        if diff < 1 << (s - 1):
                            diff -= (1 << s) - 1
                    pred[j] += diff
                    if kind == "dc first":
                        blk[base] = _i16(pred[j] << al)
                    else:
                        blk[base:base + 64] = [0] * 64
                        blk[base] = _i16(pred[j])
                if kind == "dc refine":
                    if win[p] >> 15:
                        blk[base] = _i16(blk[base] | p1)
                    p += 1
                elif kind in ("sequential", "ac first"):
                    asym, alen = ac_tabs[j]
                    last = 63 if kind == "sequential" else se
                    i = 1 if kind == "sequential" else ss
                    if eobrun:
                        eobrun -= 1
                        i = last + 1
                    while i <= last:
                        w = win[p]
                        rs = asym[w]
                        if not alen[w]:
                            raise _scan_fault(scan, "bad AC code")
                        p += alen[w]
                        r, s = rs >> 4, rs & 15
                        if s:
                            i += r
                            e = win[p] >> (16 - s)
                            p += s
                            if e < 1 << (s - 1):
                                e -= (1 << s) - 1
                            if i > last:
                                raise _scan_fault(scan, "coefficient past the band")
                            blk[base + i] = _i16(e << al)
                            i += 1
                        elif r == 15:
                            i += 16
                        else:
                            if kind == "ac first":
                                eobrun = (1 << r) - 1
                                if r:
                                    eobrun += win[p] >> (16 - r)
                                    p += r
                            break
                elif kind == "ac refine":
                    asym, alen = ac_tabs[j]
                    i = ss
                    if not eobrun:
                        while i <= se:
                            w = win[p]
                            rs = asym[w]
                            if not alen[w]:
                                raise _scan_fault(scan, "bad AC code")
                            p += alen[w]
                            r, s = rs >> 4, rs & 15
                            if s:
                                if s != 1:
                                    raise _scan_fault(scan, "bad AC refinement code")
                                s = p1 if win[p] >> 15 else m1
                                p += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    eobrun += win[p] >> (16 - r)
                                    p += r
                                break
                            # step over nonzero coefficients, each taking a
                            # correction bit, and r zero ones
                            while i <= se:
                                c = blk[base + i]
                                if c:
                                    if win[p] >> 15 and not c & p1:
                                        blk[base + i] = _i16(c + (p1 if c >= 0 else m1))
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                i += 1
                            if s:
                                if i > se:
                                    raise _scan_fault(scan, "coefficient past the band")
                                blk[base + i] = s
                            i += 1
                    if eobrun:
                        for i in range(i, se + 1):
                            c = blk[base + i]
                            if c:
                                if win[p] >> 15 and not c & p1:
                                    blk[base + i] = _i16(c + (p1 if c >= 0 else m1))
                                p += 1
                        eobrun -= 1
                if p > nbits:
                    raise _scan_fault(scan, "ends early")


class _QMDecoder:
    """``jdarith.c``'s arithmetic decoder over one restart interval's bytes
    (byte stuffing undone): registers C and A, and the bit counter that
    starts at -16 so that the first decision reads two bytes; zeros past
    the bytes' end, as libjpeg supplies at a marker."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.c, self.a, self.ct = 0, 0, -16

    def decode(self, stats: bytearray, i: int) -> int:
        """One decision in bin ``i`` of ``stats`` (the MPS in bit 7 of a
        byte, the state below it), which it updates (D.2.4 to D.2.6)."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (self.data[self.pos] if self.pos < len(self.data) else 0)
                self.pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        qe, lps, mps, switch = QE_TABLE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                stats[i] = (sv & 0x80) | mps
            else:
                stats[i] = (sv & 0x80) ^ (switch << 7) | lps
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ (switch << 7) | lps
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) | mps
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _unstuffed(interval: bytes) -> bytes:
    """A restart interval's bytes with each 0xFF (after any fill 0xFFs) and
    its stuffed 0x00 read as one 0xFF."""
    return re.sub(b"\xff+\x00", b"\xff", interval)


def _arith_magnitude(dec: _QMDecoder, stats: bytearray, st: int, x1: int, ac: bool) -> int:
    """Figures F.23 and F.24: a nonzero value's magnitude less one, its
    category from bin ``st`` (an AC value's first two from it, then from
    ``x1``; a DC value's first from it, then from ``x1``), its bits from
    the category's bin + 14.  Raises past 15 bits."""
    m = dec.decode(stats, st)
    if m and (not ac or dec.decode(stats, st)):
        m <<= int(ac)
        st = x1
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise ValueError("magnitude overflow")
            st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if dec.decode(stats, st):
            v |= m
        m >>= 1
    return v


def _decode_arith_scan(f: Frame, scan: Scan, coefs: List[List[int]], shapes) -> None:
    """Decode one arithmetic-coded scan into ``coefs``, as ``jdarith.c``
    does: sequential blocks (``decode_mcu``), or a progressive scan's DC
    first, DC refine (one fixed-estimate bit a block), AC first or AC
    refine; statistics per conditioning table (shared by the components
    that name it), DC predictors and contexts per component, all reset at
    each restart interval.  A decision past the band or a magnitude past
    15 bits (libjpeg's ``JWRN_ARITH_BAD_CODE``) raises."""
    n_units = _units(f, scan)
    blocks = _unit_blocks(f, scan, shapes)
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    kind = _scan_pass(f, scan)
    p1, m1 = 1 << al, -1 << al
    per_interval = scan.restart or n_units
    intervals = _restart_intervals(scan.coded)
    if len(intervals) < -(-n_units // per_interval):
        raise _scan_fault(scan, "no RST marker where a restart interval ends")
    fixed = bytearray([FIXED_BIN])
    for first in range(0, n_units, per_interval):
        dec = _QMDecoder(_unstuffed(intervals[first // per_interval]))
        dc_stats = {c[0]: bytearray(_DC_BINS) for c in scan.conditioning}
        ac_stats = {c[1]: bytearray(_AC_BINS) for c in scan.conditioning}
        pred, ctx = [0] * len(scan.comps), [0] * len(scan.comps)
        try:
            for unit in range(first, min(first + per_interval, n_units)):
                for j, k, base in blocks(unit):
                    blk = coefs[k]
                    dtab, atab, lo, hi, kx = scan.conditioning[j]
                    if kind in ("sequential", "dc first"):
                        stats = dc_stats[dtab]
                        st = ctx[j]
                        if not dec.decode(stats, st):
                            ctx[j] = 0
                        else:
                            sign = dec.decode(stats, st + 1)
                            st += 2 + sign
                            v = _arith_magnitude(dec, stats, st, _DC_X1, ac=False)
                            cat = 1 << (v.bit_length() - 1) if v else 0
                            if cat < (1 << lo) >> 1:
                                ctx[j] = 0
                            elif cat > (1 << hi) >> 1:
                                ctx[j] = 12 + 4 * sign
                            else:
                                ctx[j] = 4 + 4 * sign
                            pred[j] = (pred[j] + (-(v + 1) if sign else v + 1)) & 0xFFFF
                        if kind == "dc first":
                            blk[base] = _i16(pred[j] << al)
                        else:
                            blk[base:base + 64] = [0] * 64
                            blk[base] = _i16(pred[j])
                    if kind == "dc refine":
                        if dec.decode(fixed, 0):
                            blk[base] = _i16(blk[base] | p1)
                    elif kind in ("sequential", "ac first"):
                        stats = ac_stats[atab]
                        k_ = 1 if kind == "sequential" else ss
                        last = 63 if kind == "sequential" else se
                        while k_ <= last:
                            st = 3 * (k_ - 1)
                            if dec.decode(stats, st):
                                break  # end of block
                            while not dec.decode(stats, st + 1):
                                st += 3
                                k_ += 1
                                if k_ > last:
                                    raise ValueError("spectral overflow")
                            sign = dec.decode(fixed, 0)
                            v = _arith_magnitude(dec, stats, st + 2,
                                                 _AC_X_LOW if k_ <= kx else _AC_X_HIGH, ac=True)
                            blk[base + k_] = _i16((-(v + 1) if sign else v + 1) << al)
                            k_ += 1
                    elif kind == "ac refine":
                        stats = ac_stats[atab]
                        kex = se
                        while kex > 0 and not blk[base + kex]:
                            kex -= 1
                        k_ = ss
                        while k_ <= se:
                            st = 3 * (k_ - 1)
                            if k_ > kex and dec.decode(stats, st):
                                break  # end of band
                            while True:
                                c = blk[base + k_]
                                if c:
                                    if dec.decode(stats, st + 2):
                                        blk[base + k_] = _i16(c + (m1 if c < 0 else p1))
                                    break
                                if dec.decode(stats, st + 1):
                                    blk[base + k_] = _i16(m1 if dec.decode(fixed, 0) else p1)
                                    break
                                st += 3
                                k_ += 1
                                if k_ > se:
                                    raise ValueError("spectral overflow")
                            k_ += 1
        except ValueError as e:
            raise _corrupt_scan(f"arithmetic code error: {e}") from None


def _lossless_planes(f: Frame) -> List[np.ndarray]:
    """(H, W) uint8 samples of each component of a lossless frame, as
    libjpeg-turbo's ``jdlhuff.c`` and ``jdlossls.c`` give them: per sample
    (a scan's components in turn, each at 1x1) a Huffman-coded difference
    (category 16: 32768, no bits), added modulo 2^16 to its prediction (the
    first row of each restart interval: 2^(7 - Pt) at its start, then the
    sample to the left; the first column: the sample above; else the
    scan's predictor of Ra, Rb, Rc), shifted left by the point transform
    Pt into 8 bits."""
    h, w = f.height, f.width
    planes = [np.zeros((h, w), np.uint8) for _ in f.sampling]
    for scan in f.scans:
        n = len(scan.comps)
        intervals = _restart_intervals(scan.coded)
        rows = (scan.restart // w) if scan.restart else h
        if len(intervals) < -(-h // rows):
            raise _scan_fault(scan, "no RST marker where a restart interval ends")
        tabs = [_decode_tables(*t) for t in scan.dc]
        initial = 1 << (7 - scan.al)
        for y0 in range(0, h, rows):
            win, nbits = _bit_windows(intervals[y0 // rows])
            p = 0
            count = min(rows, h - y0) * w * n
            diffs = [0] * count
            for i in range(count):
                sym, length = tabs[i % n]
                wnd = win[p]
                s = sym[wnd]
                if not length[wnd]:
                    raise _scan_fault(scan, "bad difference code")
                p += length[wnd]
                if s == 16:
                    diffs[i] = 32768
                elif s:
                    d = win[p] >> (16 - s)
                    p += s
                    diffs[i] = d if d >= 1 << (s - 1) else d - (1 << s) + 1
                if p > nbits:
                    raise _scan_fault(scan, "ends early")
            for j, k in enumerate(scan.comps):
                _undifference(planes[k], diffs[j::n], y0, min(rows, h - y0), scan.ss,
                              initial, scan.al)
    return planes


def _undifference(plane: np.ndarray, diffs: List[int], y0: int, rows: int, predictor: int,
                  initial: int, pt: int) -> None:
    """Rows ``y0``.. of ``plane`` from their differences (raster order), a
    restart interval: its first row from ``initial`` and the left
    neighbour, the others by the predictor (``jdlossls.c``'s
    ``UNDIFFERENCE_1D`` and ``_2D``)."""
    w = plane.shape[1]
    prev: List[int] = []
    for r in range(rows):
        d = diffs[r * w:(r + 1) * w]
        row = [0] * w
        if r == 0:
            ra = (d[0] + initial) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                ra = (d[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (d[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                rc, rb = rb, prev[x]
                if predictor == 1:
                    px = ra
                elif predictor == 2:
                    px = rb
                elif predictor == 3:
                    px = rc
                elif predictor == 4:
                    px = ra + rb - rc
                elif predictor == 5:
                    px = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    px = rb + ((ra - rc) >> 1)
                else:
                    px = (ra + rb) >> 1
                ra = (d[x] + px) & 0xFFFF
                row[x] = ra
        prev = row
        plane[y0 + r] = (np.array(row, np.int64) << pt) & 0xFF


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
# per scan: components, their indices (4), ss, se, ah, al, restart, the
# offset and length of its coded bytes; per component slot (4) its
# arithmetic conditioning (DC table, AC table, L, U, Kx)
_SCAN_FIELDS = 12 + 4 * 5
# per scan, per component slot (4): DC then AC counts (16) and symbols (256)
_TABLE_BYTES = 16 + 256


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from ..kernels._build import build_jpeg

    lib = ctypes.CDLL(str(build_jpeg()))
    lib.icat_jpeg_decode.restype = ctypes.c_int
    lib.icat_jpeg_decode.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I32P, _I32P,
        _I32P, ctypes.c_int, _I64P, _U8P, _U8P, _U8P, ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def decode_native(data: bytes) -> np.ndarray:
    """``decode`` by the host C++ decoder (``csrc/jpeg.cc``, built with g++
    on first use): the same pixels, bit for bit.  Raises what ``parse``
    raises, ``UnsupportedImageError`` on a corrupt scan, and
    ``RuntimeError`` where the decoder cannot be built."""
    return decode_frame_native(parse(data))


def decode_frame_native(f: Frame) -> np.ndarray:
    """``decode_native`` of a parsed stream."""
    n = len(f.sampling)
    scans = np.zeros((len(f.scans), _SCAN_FIELDS), np.int64)
    tables = np.zeros((len(f.scans), 4, 2, _TABLE_BYTES), np.uint8)
    offset = 0
    for i, scan in enumerate(f.scans):
        scans[i, :1 + len(scan.comps)] = [len(scan.comps), *scan.comps]
        scans[i, 5:12] = [scan.ss, scan.se, scan.ah, scan.al, scan.restart, offset,
                          len(scan.coded)]
        for j, cond in enumerate(scan.conditioning):
            scans[i, 12 + 5 * j:17 + 5 * j] = cond
        offset += len(scan.coded)
        for j in range(len(scan.comps)):
            for t, table in enumerate((scan.dc[j], scan.ac[j])):
                if table:
                    tables[i, j, t, :16] = table[0]
                    tables[i, j, t, 16:16 + len(table[1])] = np.frombuffer(table[1], np.uint8)
    coded = np.frombuffer(b"".join(scan.coded for scan in f.scans) or b"\0", np.uint8)
    hs = np.array([s[0] for s in f.sampling], np.int32)
    vs = np.array([s[1] for s in f.sampling], np.int32)
    quant = np.ascontiguousarray(np.stack(f.quant), np.int32)
    out = np.empty((f.height, f.width, 1 if n == 1 else 3), np.uint8)
    fault = ctypes.c_int(-1)
    err = ctypes.create_string_buffer(256)
    rc = _native().icat_jpeg_decode(
        f.width, f.height, n, COLOURS[f.colour],
        4 if f.lossless else int(f.progressive) | int(f.arithmetic) << 1,
        _ptr(hs, ctypes.c_int32), _ptr(vs, ctypes.c_int32), _ptr(quant, ctypes.c_int32),
        len(f.scans), _ptr(scans, ctypes.c_int64), _ptr(tables, ctypes.c_uint8),
        _ptr(coded, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), ctypes.byref(fault), err,
        len(err))
    if rc:
        msg = err.value.decode()
        if fault.value >= 0:
            raise _scan_fault(f.scans[fault.value], msg)
        raise ValueError(msg)
    _check_ended(f)
    return out
