"""TIFF codecs, colour spaces and sample layouts past slice 18 on the CPU,
against Pillow 12.1.0 (libtiff 4.7.1, libjpeg-turbo) and the JAX package:

* every committed file of ``make_inputs.CODEC_FILES`` (JPEG-compressed
  gray, RGB and YCbCr TIFFs in strips and tiles, Zstandard and LZMA,
  YCbCr 2x2 under LZW, 4x1 under Zstandard rotated, 1x1 under LZMA with a
  ReferenceBlackWhite, CIELab (Pillow's, and random samples under
  Zstandard), CCITT RLE, Group 3 2-D and Group 4, 32-bit signed,
  float (the floating-point predictor under Zstandard, big-endian),
  signed 16-bit, 12-bit and bit-reversed 16-bit gray, the 768x512 YCbCr
  2x2 JPEG TIFF): ``read_pixels`` gives Pillow's ``convert("RGB")`` bit
  for bit, ``parse`` Pillow's mode, and both the sha256 and mode
  ``inputs.json`` records; ``read_image`` gives JAX's ``read_image``
  where the mode is ``L`` or ``RGB``, and elsewhere raises naming the
  kind, ``TIFF`` and the mode;
* the host C++ CCITT decoder against its plain Python version
  (``io/fax.py``) and Pillow on fax files of every scheme and option, and
  on damaged ones (the same outcome, the same samples); each JPEG strip or
  tile of the committed files against the numpy JPEG decoder;
* seeded files of each new layout ``make_inputs.write_tiff`` writes (YCbCr
  of each sampling libtiff's RGBA reader takes, under each codec, in
  strips and tiles, each orientation; JPEG YCbCr strips and tiles of each
  sampling; the predictors on 32-bit samples in either byte order, whose
  compressed big-endian files Pillow unpacks byte-swapped) against
  Pillow's pixels and mode;
* ``io/cielab.py``'s Lab -> sRGB against Pillow's LittleCMS transform
  on a seeded million of its 2**24 inputs and every corner of its table;
* the kinds still refused (old-style JPEG, ThunderScan, SGILog, WebP,
  planar YCbCr, one-sample YCbCr) raise ``UnsupportedImageError`` naming
  them;
* seeded cut and byte-flipped files of each new codec: wherever Pillow
  raises, the port raises ``ValueError`` (or, for Zstandard, the system's
  libzstd decodes a strip that Pillow's newer bundled libzstd calls
  corrupt); where both read, the pixels agree, but for damaged JPEG scans,
  whose recovery stays queued for the JPEG decoder as in
  ``tests/test_torch_input_tail.py``.
"""

import ctypes
import glob
import hashlib
import importlib.util
import io
import json
import os
import re
import struct

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu_torch.io import cielab, fax, jpeg, tiff, zstd
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)

with open(os.path.join(INPUTS, "inputs.json")) as _f:
    CODEC = {n: r for n, r in json.load(_f).items() if n.startswith(make_inputs.CODEC_FILES)}
KINDS = {"1": "1-bit", "I;16": "16-bit gray", "I": "32-bit integer gray",
         "F": "floating-point gray", "LAB": "CIELab"}
H, W = 37, 45


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


def _read(name: str) -> bytes:
    with open(os.path.join(INPUTS, name), "rb") as f:
        return f.read()


def _ycc(seed: int, h: int = H, w: int = W) -> np.ndarray:
    return jpeg.rgb_to_ycbcr(make_inputs.smooth(h, w, seed=seed, noise=0.2).astype(np.uint8))


def test_every_codec_fixture_is_committed():
    assert len(CODEC) >= 19 and "textured_jpeg.tif" in CODEC


@pytest.mark.parametrize("name", sorted(CODEC))
def test_committed_files_give_pillows_pixels_and_mode(name):
    path, record = os.path.join(INPUTS, name), CODEC[name]
    want, mode = _pillow(_read(name))
    assert mode == record["mode"] == tiff.parse(_read(name)).mode
    got = read_pixels(path)
    np.testing.assert_array_equal(got, want)
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == record["sha256"]
    if mode in ("L", "RGB"):
        ours, jax = read_image(path), j_read_image(path)
        assert ours[1:] == jax[1:] == tuple(record["shape"][:2])
        np.testing.assert_array_equal(ours[0], jax[0])
    else:
        with pytest.raises(UnsupportedImageError,
                           match=f"a {re.escape(KINDS[mode])} TIFF \\(Pillow's mode "
                                 f"{re.escape(mode)}\\)"):
            read_image(path)


@pytest.mark.parametrize("name", sorted(n for n in CODEC if "jpeg" in n))
def test_jpeg_strips_equal_the_numpy_decoder(name):
    t = tiff.parse(_read(name))
    frames = tiff.jpeg_frames(t)
    assert len(frames) == len(t.chunks) > 1
    for f in frames[:6]:
        np.testing.assert_array_equal(jpeg.decode_frame_native(f), jpeg.decode_frame(f))


def _pillow_fax(compression: str, seed: int, **kwargs) -> bytes:
    bw = Image.fromarray(make_inputs.bilevel(14, 300 + 7 * seed, seed)).convert("1")
    buf = io.BytesIO()
    bw.save(buf, format="TIFF", compression=compression, **kwargs)
    return buf.getvalue()


FAX_CASES = {
    "rle": dict(compression="tiff_ccitt"),
    "rle-fill2": dict(compression="tiff_ccitt", tiffinfo={266: 2}),
    "g3-1d": dict(compression="group3"),
    "g3-1d-eol-aligned": dict(compression="group3", tiffinfo={292: 4}),
    "g3-2d": dict(compression="group3", tiffinfo={292: 1}),
    "g3-2d-strips": dict(compression="group3", tiffinfo={292: 5}, strip_size=50),
    "g4": dict(compression="group4"),
    "g4-miniswhite-strips": dict(compression="group4", tiffinfo={262: 0}, strip_size=80),
    "g4-fill2": dict(compression="group4", tiffinfo={266: 2}),
}


@pytest.mark.parametrize("case", sorted(FAX_CASES))
def test_ccitt_decoder_equals_its_plain_version_and_pillow(case):
    data = _pillow_fax(seed=sorted(FAX_CASES).index(case), **FAX_CASES[case])
    t = tiff.parse(data)
    native = tiff.decode_samples(t)
    plain, outcome = tiff.fax_samples(t)
    assert outcome == fax.OK
    np.testing.assert_array_equal(native, plain)
    want, mode = _pillow(data)
    assert mode == t.mode == "1"
    np.testing.assert_array_equal(tiff.decode_tiff_native(t), want)


@pytest.mark.parametrize("scheme", ["tiff_ccitt", "group3-2d", "group4"])
def test_damaged_ccitt_chunks_come_out_alike_in_both_decoders(scheme):
    rng = np.random.RandomState(len(scheme))
    kwargs = dict(compression="group3", tiffinfo={292: 1}) if scheme == "group3-2d" else \
        dict(compression=scheme)
    t0 = tiff.parse(_pillow_fax(seed=7, **kwargs))
    whole, outcomes = t0.chunks[0], set()
    for _ in range(40):
        chunk = bytearray(whole)
        if rng.rand() < 0.4:
            chunk = chunk[:rng.randint(len(chunk))]
        else:
            for at in rng.randint(0, len(chunk), rng.randint(1, 4)):
                chunk[at] = rng.randint(256)
        t0.chunks = [bytes(chunk)]
        plain, outcome = tiff.fax_samples(t0)
        outcomes.add(outcome)
        if outcome == fax.OK:
            np.testing.assert_array_equal(tiff.decode_samples(t0), plain)
            continue
        with pytest.raises(UnsupportedImageError, match="TIFF CCITT"):
            tiff.decode_samples(t0)
    assert len(outcomes) > 1


def _case(name: str) -> bytes:
    """A seeded TIFF of one new layout, by its name."""
    kind, _, rest = name.partition(":")
    i = sum(map(ord, name)) % 97
    if kind == "ycbcr":  # ycbcr:<h>x<v>:<compression>:<strips|tiles>
        hv, comp, layout = rest.split(":")
        sampling = tuple(int(v) for v in hv.split("x"))
        tile = (16, 16) if layout == "tiles" else None
        return make_inputs.write_tiff(_ycc(i), 8, 6, compression=int(comp), subsampling=sampling,
                                      tile=tile, rows_per_strip=8 if sampling[1] < 4 else 12)
    if kind == "orientation":  # libtiff's RGBA reader flips nothing; Pillow transposes
        return make_inputs.write_tiff(_ycc(i), 8, 6, compression=32773, subsampling=(2, 2),
                                      rows_per_strip=10, orientation=int(rest))
    if kind == "jpeg":  # jpeg:<h>x<v>:<strips|tiles>
        hv, layout = rest.split(":")
        sampling = tuple(int(v) for v in hv.split("x"))
        tile = (32, 16 * sampling[1]) if layout == "tiles" else None
        return make_inputs.write_tiff(_ycc(i, 50, 70), 8, 6, compression=7, subsampling=sampling,
                                      tile=tile, rows_per_strip=16 * sampling[1])
    if kind == "jpeg-gray":
        return make_inputs.write_tiff(_ycc(i)[..., :1], 8, 1, compression=7, tile=(32, 16))
    if kind == "jpeg-rgb":
        return make_inputs.write_tiff(_ycc(i), 8, 2, compression=7, rows_per_strip=8,
                                      orientation=3)
    if kind == "float":  # float:<predictor>:<compression>:<order>
        pred, comp, order = rest.split(":")
        f = np.random.RandomState(i).rand(H, W, 1).astype(np.float32) * 400 - 60
        return make_inputs.write_tiff(f.view(np.uint32).astype(np.int64), 32, 1,
                                      compression=int(comp), predictor=int(pred), sample_format=3,
                                      order=order, rows_per_strip=9)
    if kind == "int":  # int:<bits>:<format>:<compression>:<order>
        bits, fmt, comp, order = (int(v) if v.isdigit() else v for v in rest.split(":"))
        v = np.random.RandomState(i).randint(-400, 700, (H, W, 1)) % (1 << bits)
        return make_inputs.write_tiff(v, bits, 1, compression=comp, predictor=2 if comp != 1 else 1,
                                      sample_format=fmt, order=order, tile=(16, 16))
    if kind == "gray12":
        return make_inputs.write_tiff(make_inputs.smooth(H, W, seed=i, channels=1, levels=4096),
                                      12, 1, compression=int(rest), rows_per_strip=5)
    if kind == "gray16-reversed":
        v = make_inputs.smooth(H, W, seed=i, channels=1, levels=1 << 16) // 100
        return make_inputs.write_tiff(v, 16, 1, compression=int(rest), fill_order=2,
                                      predictor=2 if rest == "5" else 1)
    if kind == "ycbcr-coefficients":
        return make_inputs.write_tiff(_ycc(i), 8, 6, compression=5, subsampling=(2, 1), fields=[
            (529, 5, [2126, 10000, 7152, 10000, 722, 10000]),
            (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])])
    if kind == "lab":  # lab:<compression>: random L*, a*, b* samples
        lab = np.random.RandomState(i).randint(0, 256, (H, W, 3))
        return make_inputs.write_tiff(lab, 8, 8, compression=int(rest), tile=(16, 32),
                                      order=">" if rest == "5" else "<")
    if kind == "ycbcr-raw":  # Pillow's raw reader takes 4 bytes a pixel (RGBX)
        data = make_inputs.write_tiff(_ycc(i), 8, 6)
        return data + bytes(range(256)) * 8 if rest == "padded" else data
    raise KeyError(name)


LAYOUTS = (
    [f"ycbcr:{h}x{v}:{c}:strips" for h, v in ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
     for c in (5, 32773, 8, 50000, 34925)]
    + [f"ycbcr:{hv}:{c}:tiles" for hv in ("1x1", "2x2", "4x2") for c in (5, 50000)]
    + [f"orientation:{o}" for o in range(2, 9)]
    + [f"jpeg:{hv}:{layout}" for hv in ("1x1", "2x1", "1x2", "2x2")
       for layout in ("strips", "tiles")]
    + ["jpeg-gray", "jpeg-rgb"]
    + [f"float:{p}:{c}:{o}" for p in (2, 3) for c in (8, 50000, 34925, 5) for o in "<>"]
    + [f"int:{b}:{f}:{c}:{o}" for b, f in ((32, 2), (16, 2)) for c in (1, 5, 50000)
       for o in "<>"] + ["int:32:1:34925:<"]
    + ["gray12:1", "gray12:5", "gray12:50000", "gray16-reversed:1", "gray16-reversed:5",
       "ycbcr-coefficients", "ycbcr-raw:padded", "ycbcr-raw:bare", "lab:1", "lab:5", "lab:34925"]
)


@pytest.mark.parametrize("name", LAYOUTS)
def test_each_new_layout_gives_pillows_pixels_and_mode(name):
    data = _case(name)
    try:
        want, mode = _pillow(data)
    except OSError:  # an uncompressed YCbCr strip Pillow's raw reader runs past
        with pytest.raises(ValueError, match="truncated") as e:
            tiff.decode_native(data)
        assert not isinstance(e.value, UnsupportedImageError)
        return
    t = tiff.parse(data)
    assert t.mode == mode
    np.testing.assert_array_equal(tiff.decode_tiff_native(t), want)


def _webp_in_tiff() -> bytes:
    """A hand-built TIFF whose strip is a lossless WebP (compression 50001)."""
    rgb = make_inputs.smooth(16, 16, seed=1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="WEBP", lossless=True)
    data = bytearray(make_inputs.write_tiff(rgb, 8, 2))
    ifd = struct.unpack_from("<I", data, 4)[0]
    at = len(data)
    data += buf.getvalue()
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        pos = ifd + 2 + 12 * i
        tag = struct.unpack_from("<H", data, pos)[0]
        value = {259: 50001, 273: at, 279: len(buf.getvalue())}.get(tag)
        if value is not None:
            struct.pack_into("<I" if tag != 259 else "<HH", data, pos + 8,
                             *((value,) if tag != 259 else (value, 0)))
    return bytes(data)


def test_the_kinds_still_queued_raise_naming_them():
    field = b"\x03\x01\x03\x00\x01\x00\x00\x00"  # Compression, SHORT, 1 value
    group4 = _pillow_fax("group4", seed=1)
    webp = _webp_in_tiff()
    with pytest.raises(OSError):
        _pillow(webp)  # this Pillow's libtiff has no WebP codec: the refusal is parity
    named = {
        "old-style JPEG TIFFs": group4.replace(field + b"\x04\x00", field + b"\x06\x00"),
        "ThunderScan TIFFs": group4.replace(field + b"\x04\x00", field + b"\x29\x80"),
        "SGILog TIFFs": group4.replace(field + b"\x04\x00", field + b"\x74\x87"),
        "WebP TIFFs": webp,
        "photometric interpretation 6, sample format (1,), fill order 1, bits (8,)":
            make_inputs.write_tiff(np.zeros((4, 4, 1), np.int64), 8, 6, compression=5),
        "planar YCbCr TIFFs": make_inputs.write_tiff(_ycc(3, 8, 8), 8, 6, planar=2, compression=5,
                                                      subsampling=(1, 1)),
    }
    for match, data in named.items():
        with pytest.raises(UnsupportedImageError, match=re.escape(match)):
            tiff.decode_native(data)


def test_lab_to_rgb_equals_pillows_littlecms():
    rng = np.random.RandomState(0)
    corners = np.stack(np.meshgrid(*[[0, 1, 127, 128, 254, 255]] * 3, indexing="ij"), -1)
    lab = np.concatenate([corners.reshape(-1, 3), rng.randint(0, 256, (1 << 20, 3))]).astype(np.uint8)
    im = Image.frombytes("LAB", (len(lab), 1), (lab ^ np.array([0, 128, 128], np.uint8)).tobytes())
    np.testing.assert_array_equal(cielab.lab_to_rgb(lab), np.asarray(im.convert("RGB"))[0])


def _damaged(rng, data: bytes) -> bytes:
    """``data`` cut short, or with a few bytes set to random values."""
    if rng.rand() < 0.3:
        return data[:rng.randint(8, len(data))]
    out = bytearray(data)
    for at in rng.randint(0, len(data), rng.randint(1, 4)):
        out[at] = rng.randint(256)
    return bytes(out)


DAMAGED = {
    "jpeg-ycbcr": lambda: make_inputs.write_tiff(_ycc(1, 40, 48), 8, 6, compression=7,
                                                 subsampling=(2, 2), rows_per_strip=16),
    "jpeg-rgb": lambda: make_inputs.write_tiff(_ycc(2, 24, 40), 8, 2, compression=7,
                                               tile=(16, 16)),
    "zstd": lambda: make_inputs.write_tiff(_ycc(3, 24, 40), 8, 2, compression=50000, predictor=2,
                                           rows_per_strip=6),
    "lzma": lambda: make_inputs.write_tiff(_ycc(4, 24, 40), 8, 2, compression=34925,
                                           rows_per_strip=6),
    "ycbcr-lzw": lambda: make_inputs.write_tiff(_ycc(5, 24, 40), 8, 6, compression=5,
                                                subsampling=(2, 2), rows_per_strip=6),
    "g3": lambda: _pillow_fax("group3", seed=2, tiffinfo={292: 1}),
    "g4": lambda: _pillow_fax("group4", seed=3),
    "float-zstd": lambda: make_inputs.write_tiff(
        (np.random.RandomState(6).rand(24, 40, 1).astype(np.float32) * 300)
        .view(np.uint32).astype(np.int64), 32, 1, compression=50000, predictor=3, sample_format=3),
}


def _pillows_libzstd_refuses(data: bytes) -> bool:
    """Whether the libzstd that Pillow's wheel bundles (1.5.7 in Pillow
    12.1.0's, newer than a system's 1.5.4, which detects less corruption),
    put in the port's place, fails on a strip of ``data``."""
    here = os.path.dirname(os.path.dirname(Image.__file__))
    found = glob.glob(os.path.join(here, "pillow.libs", "libzstd-*.so*"))
    if not found:
        return False
    lib = ctypes.CDLL(found[0])
    system = zstd.library()
    for name in ("ZSTD_isError", "ZSTD_getErrorName", "ZSTD_createDCtx", "ZSTD_freeDCtx",
                 "ZSTD_decompressStream"):
        getattr(lib, name).restype = getattr(system, name).restype
        getattr(lib, name).argtypes = getattr(system, name).argtypes
    saved = zstd.library
    zstd.library = lambda: lib
    try:
        tiff.parse(data)
    except ValueError:
        return True
    finally:
        zstd.library = saved
    return False


@pytest.mark.parametrize("codec", sorted(DAMAGED))
def test_damaged_files_raise_where_pillow_raises(codec):
    rng = np.random.RandomState(sorted(DAMAGED).index(codec))
    data = DAMAGED[codec]()
    for _ in range(60):
        bad = _damaged(rng, data)
        try:
            want = _pillow(bad)[0]
        except Exception:  # noqa: BLE001 (Pillow raises many kinds)
            try:
                tiff.decode_native(bad)
            except ValueError:
                continue
            assert "zstd" in codec and _pillows_libzstd_refuses(bad), \
                "Pillow raises, the port reads"
            continue
        try:
            got = tiff.decode_native(bad)
        except ValueError:
            continue  # stricter than Pillow: allowed
        if "jpeg" not in codec:
            np.testing.assert_array_equal(got, want)
