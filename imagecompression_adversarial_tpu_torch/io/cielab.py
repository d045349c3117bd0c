"""Pillow's ``convert("RGB")`` of a ``LAB`` image, without PIL or
LittleCMS: the sRGB pixels of 8-bit CIELab samples.

Pillow converts ``LAB`` through LittleCMS (``ImageCms.buildTransform``
from ``createProfile("LAB")``, a V2 Lab identity profile with a D50 white,
to ``createProfile("sRGB")``, perceptual intent, no flags; lcms2 2.17 in
Pillow 12.1's wheel).  LittleCMS optimizes that transform into one stage:
a 33x33x33 table of 16-bit sRGB values (``OptimizeByResampling``), which
it evaluates by tetrahedral interpolation (``TetrahedralInterp16``) of the
input bytes widened to 16 bits (x * 257), then narrows to 8 bits
(``FROM_16_TO_8``).  ``lab_table`` builds that table as LittleCMS samples
it, each node through its float pipeline in float32 between the stages
(``From16ToFloat``; ``EvaluateLab2XYZ``: V4 Lab, ``cmsLab2XYZ`` to D50,
over the 1.15 fixed-point PCS range; the sRGB profile's XYZ -> linear RGB
matrix, its Rec. 709 primaries and D65 white adapted to D50 by Bradford;
the inverse of its parametric type 4 curve; ``_cmsQuickSaturateWord``);
``lab_to_rgb`` interpolates it.  The tests hold the result to Pillow's on
every kind of input (``tests/test_torch_tiff_codecs.py``).

Pillow's ``LAB`` bytes are L (0..255 for 0..100) and a, b offset by 128;
a TIFF stores a and b signed, and Pillow's ``LAB`` unpacker flips their
high bits (``io/tiff.py``).
"""

from __future__ import annotations

import functools

import numpy as np

_GRID = 33
# lcms2's D50 white (cmsD50_XYZ) and the PCS XYZ range (MAX_ENCODEABLE_XYZ)
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0
# cmsCreate_sRGBProfile: the D65 white and Rec. 709 primaries (xy), and the
# sRGB curve as parametric type 4 (gamma, a, b, c, d)
_D65_XY = (0.3127, 0.3290)
_PRIMARIES_XY = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
_SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_BRADFORD = np.array([[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367],
                      [0.0389, -0.0685, 1.0296]])


def _xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def _xyz_to_linear_srgb() -> np.ndarray:
    """The sRGB profile's PCS XYZ -> linear RGB matrix as lcms2's
    ``BuildRGBOutputMatrixShaper`` applies it: the inverse of the
    colorants (Rec. 709 primaries scaled to the D65 white, adapted to D50
    by Bradford), scaled by the PCS range."""
    white = _xyz(*_D65_XY)
    primaries = np.stack([_xyz(*p) for p in _PRIMARIES_XY], 1)
    colorants = primaries * np.linalg.solve(primaries, white)
    adapt = np.linalg.inv(_BRADFORD) @ np.diag((_BRADFORD @ np.array(_D50))
                                                / (_BRADFORD @ white)) @ _BRADFORD
    return np.linalg.inv(adapt @ colorants) * _MAX_XYZ


@functools.lru_cache(maxsize=None)
def lab_table() -> np.ndarray:
    """(33, 33, 33, 3) int64: LittleCMS's 16-bit sRGB node of each grid
    point (L, a, b) of its optimized Lab -> sRGB transform."""
    f32 = np.float32
    nodes = np.floor(np.arange(_GRID) * 65535 / (_GRID - 1) + 0.5)  # _cmsQuantizeVal
    v = (nodes.astype(f32) / f32(65535)).astype(np.float64)
    lab_l, lab_a, lab_b = np.meshgrid(v * 100.0, v * 255.0 - 128.0, v * 255.0 - 128.0,
                                      indexing="ij")
    fy = (lab_l + 16.0) / 116.0
    xyz = []
    for t, white in zip((fy + 0.002 * lab_a, fy, fy - 0.005 * lab_b), _D50):
        f = np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)
        xyz.append((f * white / _MAX_XYZ).astype(f32).astype(np.float64))
    m = _xyz_to_linear_srgb()
    gamma, a, b, c, d = _SRGB_CURVE
    disc = (a * d + b) ** gamma
    out = []
    for row in m:
        lin = (row[0] * xyz[0] + row[1] * xyz[1] + row[2] * xyz[2]).astype(f32).astype(np.float64)
        with np.errstate(invalid="ignore"):
            enc = np.where(lin >= disc, (np.power(np.maximum(lin, 0.0), 1.0 / gamma) - b) / a,
                           lin / c)
        enc = enc.astype(f32).astype(np.float64)
        out.append(np.clip(np.floor(enc * 65535.0 + 0.5), 0, 65535))
    return np.stack(out, -1).astype(np.int64)


def _tetrahedral(table: np.ndarray, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """lcms2's ``TetrahedralInterp16`` of (n,) 16-bit inputs: (n, 3)."""
    flat = table.reshape(-1)
    base = np.zeros(x.shape, np.int64)
    rest, up = [], []
    for v, step in zip((x, y, z), (3 * _GRID * _GRID, 3 * _GRID, 3)):
        a = v * (_GRID - 1)
        fixed = a + (a + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
        base += (fixed >> 16) * step
        rest.append(fixed & 0xFFFF)
        up.append(np.where(v == 0xFFFF, 0, step))
    rx, ry, rz = rest
    # the axes the tetrahedron climbs first and last, in TetrahedralInterp16's
    # six cases and their order of comparisons
    cases = [(rx >= ry) & (ry >= rz), (rx >= ry) & (rz >= rx), rx >= ry, rx >= rz, ry >= rz]
    first = np.select(cases, [0, 2, 0, 1, 1], 2)
    last = np.select(cases, [2, 1, 1, 2, 0], 0)
    middle = 3 - first - last
    rest, up, idx = np.stack(rest, -1), np.stack(up, -1), np.arange(len(x))
    p1 = base + up[idx, first]
    p2 = p1 + up[idx, middle]
    p3 = p2 + up[idx, last]
    out = np.empty((len(x), 3), np.int64)
    for ch in range(3):
        c0, v1, v2, v3 = flat[base + ch], flat[p1 + ch], flat[p2 + ch], flat[p3 + ch]
        acc = (v1 - c0) * rest[idx, first] + (v2 - v1) * rest[idx, middle] \
            + (v3 - v2) * rest[idx, last] + 0x8001
        out[:, ch] = (c0 + ((acc + (acc >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB of (..., 3) uint8 ``LAB`` bytes as Pillow holds
    them (L, a + 128, b + 128): ``Image.convert("RGB")``, bit for bit."""
    flat = np.asarray(lab, np.int64).reshape(-1, 3) * 257  # FROM_8_TO_16
    rgb16 = _tetrahedral(lab_table(), flat[:, 0], flat[:, 1], flat[:, 2])
    rgb = (rgb16 * 65281 + 8388608) >> 24  # FROM_16_TO_8
    return rgb.astype(np.uint8).reshape(*np.shape(lab)[:-1], 3)
