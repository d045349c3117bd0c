"""The port's baseline JPEG decoders against Pillow (libjpeg-turbo) on the
CPU: the host C++ decoder (``csrc/jpeg.cc``, ``io/jpeg.py::decode_native``,
built with g++), its plain numpy version (``io/jpeg.py::decode``) and
``PIL.Image.open`` give equal pixels (``np.array_equal``) on files Pillow
writes: qualities 10, 50, 90 and 100; YCbCr at 4:4:4, 4:2:2 and 4:2:0 and
gray; restart intervals (``restart_marker_blocks``,
``restart_marker_rows``); sizes that are not multiples of 8 or 16, down to
1x1.  Progressive and CMYK files, refused up to slice 15, decode to
Pillow's ``convert("RGB")`` (``read_image`` refuses CMYK, naming Pillow's
mode), and since slice 18 so do YCCK and Adobe RGB-coded files (made by
patching a CMYK or baseline file's markers) and 4:4:0 ones (written by
``make_inputs.encode_jpeg``).  Since slice 20 so do arithmetic-coded
files, sequential and progressive (``make_inputs.encode_arith_jpeg``,
``jcarith.c``'s coder: every sampling, restart intervals, DAC
conditioning, gray and CMYK), and lossless ones
(``make_inputs.encode_lossless_jpeg``: predictors 1-7, point transforms,
restart intervals, one scan or one a component, gray and RGB).  What
neither decoder reads raises ``UnsupportedImageError`` naming it, and
Pillow raises on each too: 12-bit, hierarchical and arithmetic-coded
lossless files (patched markers), a lossless YCbCr file, an
arithmetic-coded scan that runs past Pillow's 65,536-byte read block; and
a corrupt scan that Pillow
decodes with libjpeg's warning (a bad Huffman code, a lost or misnumbered
RSTn, a scan cut short before EOI).  Extraneous bytes before a marker are
skipped, giving Pillow's pixels.  A broken stream, or one cut inside its
scan (Pillow calls it truncated), raises a plain ``ValueError``; a whole
scan with no EOI after it raises naming it, as Pillow reads it or not by
libjpeg's buffering; a decoder that cannot be built raises, and nothing
falls back to the numpy loop.
"""

import functools
import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu_torch.io import jpeg
from imagecompression_adversarial_tpu_torch.io.errors import (RefusedByPillowError,
                                                              UnsupportedImageError)
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.kernels import _build

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)

SAMPLINGS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "gray": None}
SIZES = [(37, 53), (64, 64), (9, 3), (1, 1), (17, 2)]


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + seed), 128 + 90 * np.cos(yy / 5.0),
                    128 + 60 * np.sin((xx + yy) / 9.0)], -1) + rng.rand(h, w, 3) * 60
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(rgb, kind="4:2:0", **kwargs):
    """Pillow's bytes of ``rgb`` (its first channel for ``gray``) and its
    decode of them, (H, W, channels)."""
    buf = io.BytesIO()
    if kind == "gray":
        Image.fromarray(rgb[..., 0], "L").save(buf, format="JPEG", **kwargs)
    else:
        Image.fromarray(rgb).save(buf, format="JPEG", subsampling=SAMPLINGS[kind], **kwargs)
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)))
    return data, want.reshape(*want.shape[:2], -1)


def _all_equal(data, want):
    np.testing.assert_array_equal(jpeg.decode_native(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)


@pytest.mark.parametrize("kind", list(SAMPLINGS))
@pytest.mark.parametrize("quality", [10, 50, 90, 100])
def test_both_decoders_give_pillows_pixels(quality, kind):
    for i, (h, w) in enumerate(SIZES):
        data, want = _pillow(_image(h, w, seed=quality + i), kind, quality=quality)
        _all_equal(data, want)


@pytest.mark.parametrize("kind", list(SAMPLINGS))
@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}])
def test_restart_intervals(kind, restart):
    data, want = _pillow(_image(45, 70, seed=7), kind, quality=80, **restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _all_equal(data, want)


def _segment(data: bytes, code: int) -> int:
    """The offset of the first marker segment ``0xFF code``."""
    pos = 2
    while data[pos + 1] != code:
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def _patched(data: bytes, code: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` into the body of marker ``code``
    set to ``value``."""
    out = bytearray(data)
    out[_segment(data, code) + 4 + offset] = value
    return bytes(out)


@functools.lru_cache(maxsize=None)
def _variants():
    rgb = _image(32, 32, seed=1)
    base, _ = _pillow(rgb, quality=75)
    progressive, _ = _pillow(rgb, quality=75, progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(cmyk, format="JPEG")
    app0 = _segment(base, 0xE0)
    length = struct.unpack(">H", base[app0 + 2:app0 + 4])[0]
    adobe = (base[:app0] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
             + base[app0 + 2 + length:])
    ycck = _patched(cmyk.getvalue(), 0xEE, 11, 2)
    ycc = [p for p in np.moveaxis(jpeg.rgb_to_ycbcr(rgb), -1, 0)]
    lossless = make_inputs.encode_lossless_jpeg(list(np.moveaxis(rgb, -1, 0)), 4)
    hierarchical = bytearray(base)
    hierarchical[_segment(base, 0xC0) + 1] = 0xC5
    arith_lossless = bytearray(lossless)
    arith_lossless[_segment(lossless, 0xC3) + 1] = 0xCB
    big = _image(384, 512, seed=2)
    big_arith = make_inputs.encode_arith_jpeg(list(np.moveaxis(jpeg.rgb_to_ycbcr(big), -1, 0)),
                                              [(1, 1)] * 3, quality=95)
    assert len(big_arith) > jpeg.PILLOW_BLOCK
    return {
        "progressive": (progressive, None),
        "arithmetic": (make_inputs.encode_arith_jpeg(ycc, [(2, 2), (1, 1), (1, 1)], 75), None),
        "lossless": (lossless, None),
        "12-bit": (_patched(base, 0xC0, 0, 12), "12-bit JPEGs"),
        "hierarchical": (bytes(hierarchical), "hierarchical sequential JPEGs"),
        "arithmetic-lossless": (bytes(arith_lossless), "arithmetic-coded lossless JPEGs"),
        "lossless-ycbcr": (make_inputs.encode_lossless_jpeg(ycc, 1, jfif=True),
                           "lossless JPEGs in YCbCr"),
        "lossless-ycck": (make_inputs.encode_lossless_jpeg([*ycc, ycc[0]], 1, adobe=2, jfif=False),
                          "lossless JPEGs in YCCK"),
        "arithmetic-past-block": (big_arith, "arithmetic-coded JPEGs whose scan runs past byte "
                                             "65536"),
        "cmyk": (cmyk.getvalue(), None),
        "ycck": (ycck, None),
        "adobe-rgb": (adobe, None),
        "4:4:0": (make_inputs.encode_jpeg([p for p in np.moveaxis(jpeg.rgb_to_ycbcr(rgb), -1, 0)],
                                          [(1, 2), (1, 1), (1, 1)], quality=75), None),
    }


@pytest.mark.parametrize("kind", list(_variants()))
def test_what_neither_decoder_reads_raises_naming_it(kind, tmp_path):
    """Each kind raises naming it, as Pillow does, but the progressive,
    CMYK, YCCK, Adobe RGB-coded, 4:4:0, arithmetic-coded and lossless
    files, which both decoders now give Pillow's ``convert("RGB")`` of, and
    ``read_image`` refuses CMYK and YCCK naming Pillow's mode."""
    data, match = _variants()[kind]
    if match is None:
        _all_equal(data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        if kind in ("cmyk", "ycck"):
            with pytest.raises(UnsupportedImageError, match="Pillow's mode CMYK"):
                read_image(str(path))
        else:
            np.testing.assert_array_equal(read_image(str(path), padding=1)[0][0],
                                          read_pixels(str(path)) / np.float32(255))
        return
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(RefusedByPillowError, match=match):
            decode(data)


ARITH_KINDS = {  # (sampling, or None for gray; encode_arith_jpeg's options)
    "sequential-420": ([(2, 2), (1, 1), (1, 1)], {}),
    "sequential-444-restart": ([(1, 1)] * 3, dict(restart=3)),
    "sequential-422-dac": ([(2, 1), (1, 1), (1, 1)],
                           dict(conditioning={(0, 0): 0x41, (0, 1): 0x20, (1, 0): 20, (1, 1): 1})),
    "sequential-gray-restart": (None, dict(restart=5)),
    "progressive-420": ([(2, 2), (1, 1), (1, 1)], dict(script=make_inputs.PROGRESSION_3)),
    "progressive-440-restart": ([(1, 2), (1, 1), (1, 1)],
                                dict(script=make_inputs.PROGRESSION_3, restart=2)),
    "progressive-gray-dac": (None, dict(script=make_inputs.PROGRESSION_1,
                                        conditioning={(0, 0): 0xF0, (1, 0): 63})),
}


@pytest.mark.parametrize("kind", list(ARITH_KINDS))
def test_arithmetic_coded_files_give_pillows_pixels(kind):
    """``jdarith.c``'s decoding in both decoders, on files of ``jcarith.c``'s
    coder at each size of SIZES, qualities 30 to 90."""
    sampling, options = ARITH_KINDS[kind]
    for i, (h, w) in enumerate(SIZES):
        ycc = jpeg.rgb_to_ycbcr(_image(h, w, seed=11 * i))
        planes = [ycc[..., 0]] if sampling is None else list(np.moveaxis(ycc, -1, 0))
        data = make_inputs.encode_arith_jpeg(planes, sampling or [(1, 1)], 30 + 15 * i, **options)
        _, want = _pillow_pixels(data)
        _all_equal(data, want)


LOSSLESS_KINDS = {  # (Pillow's mode, encode_lossless_jpeg's options)
    "rgb": ("RGB", {}),
    "gray-pt2-restart": ("L", dict(pt=2, restart_rows=2)),
    "rgb-scans-pt1-restart": ("RGB", dict(pt=1, interleaved=False, restart_rows=1)),
    "rgb-ids-pt7": ("RGB", dict(pt=7, ids=[82, 71, 66])),
    "cmyk-adobe": ("CMYK", dict(adobe=0)),
}


@pytest.mark.parametrize("kind", list(LOSSLESS_KINDS))
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_files_give_pillows_pixels(predictor, kind):
    """Lossless (SOF3) files in both decoders at each size of SIZES:
    libjpeg-turbo 3 reads three components with no JFIF or Adobe marker as
    RGB whatever their ids; CMYK through Pillow's ``convert("RGB")``."""
    mode, options = LOSSLESS_KINDS[kind]
    for i, (h, w) in enumerate(SIZES):
        rgb = _image(h, w, seed=predictor + 5 * i)
        samples = {"L": rgb[..., 1:2], "RGB": rgb,
                   "CMYK": np.concatenate([rgb, 255 - rgb[..., :1]], -1)}[mode]
        data = make_inputs.encode_lossless_jpeg(list(np.moveaxis(samples, -1, 0)), predictor,
                                                **options)
        got_mode, want = _pillow_pixels(data)
        assert got_mode == mode == jpeg.parse(data).mode
        if mode == "CMYK":
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        _all_equal(data, want)


def test_a_lossless_restart_interval_of_part_of_a_row_raises_a_value_error():
    """libjpeg-turbo takes a lossless restart interval only in whole rows
    (``JERR_BAD_RESTART``), and Pillow raises."""
    data = make_inputs.encode_lossless_jpeg([_image(12, 10, seed=3)[..., 0]], 1)
    at = _segment(data, 0xC4)
    data = data[:at] + b"\xff\xdd\x00\x04\x00\x0f" + data[at:]  # 15 samples
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(ValueError, match="not whole rows of 10"):
            decode(data)


def _pillow_pixels(data: bytes):
    """Pillow's mode of ``data`` and its pixels, (H, W, channels)."""
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
        return im.mode, want.reshape(*want.shape[:2], -1)


def _junk(data: bytes, junk: bytes) -> bytes:
    """``data`` with ``junk`` between its APP0 and its first DQT."""
    at = _segment(data, 0xDB)
    return data[:at] + junk + data[at:]


@pytest.mark.parametrize("junk", [b"\x00\x12junk", b"\xff\x00\x33", b"\xff\xff\xff", b"\x07"])
def test_extraneous_bytes_before_a_marker_are_skipped(junk):
    """libjpeg's ``next_marker`` and Pillow's header parser skip bytes that
    are not 0xFF, escaped 0xFF 0x00 pairs and fill 0xFFs."""
    data, _ = _pillow(_image(37, 53, seed=5), quality=90)
    data = _junk(data, junk)
    _all_equal(data, np.asarray(Image.open(io.BytesIO(data))))


def _scan_start(data: bytes) -> int:
    at = _segment(data, 0xDA)
    return at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]


def _corrupt_scans():
    base, _ = _pillow(_image(48, 72, seed=6), quality=90)
    rst, _ = _pillow(_image(48, 72, seed=6), quality=90, restart_marker_blocks=2)
    s0, r3 = _scan_start(base), rst.index(b"\xff\xd3")
    return {
        # 48 one bits: a code starts among them, and no code is all ones
        "bad code": (base[:s0 + 40] + b"\xff\x00" * 3 + base[s0 + 46:], "bad AC code"),
        "lost RST": (rst[:r3] + rst[r3 + 2:], "6 RST markers where its restart intervals need 7"),
        "misnumbered RST": (rst[:r3] + b"\xff\xd5" + rst[r3 + 2:], "RST5 where RST3 belongs"),
        "cut before EOI": (base[:len(base) // 2] + b"\xff\xd9", "ends early"),
    }


@pytest.mark.parametrize("kind", list(_corrupt_scans()))
def test_a_corrupt_scan_pillow_reads_raises_naming_it(kind):
    """Pillow decodes these (libjpeg warns, fills zeros or resyncs), so
    JAX's reader keeps them: neither decoder gives other pixels, and the
    error is not the plain ``ValueError`` a folder reader skips."""
    data, match = _corrupt_scans()[kind]
    assert np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).shape == (48, 72, 3)
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(UnsupportedImageError, match=f"corrupt JPEG scan .*{match}"):
            decode(data)


def test_a_file_cut_inside_its_scan_raises_a_value_error():
    """The scan runs out of bytes with no marker after it: libjpeg waits for
    more and Pillow raises ``OSError``, so JAX's folder reader skips the
    file, and the port's may."""
    data, _ = _pillow(_image(48, 72, seed=6), quality=90)
    rst, _ = _pillow(_image(48, 72, seed=6), quality=90, restart_marker_blocks=2)
    for cut in (data[:len(data) // 2], rst[:rst.index(b"\xff\xd3") - 1]):
        with pytest.raises(OSError, match="truncated"):
            Image.open(io.BytesIO(cut)).convert("RGB")
        for decode in (jpeg.decode, jpeg.decode_native):
            with pytest.raises(ValueError, match="truncated") as e:
                decode(cut)
            assert not isinstance(e.value, UnsupportedImageError)


@pytest.mark.parametrize("h, w", [(48, 72), (41, 47)])
def test_a_whole_scan_with_no_marker_after_it_raises_naming_it(h, w):
    """EOI cut off: Pillow calls the first file truncated and reads the
    second, as libjpeg's input buffer falls, so the port raises on both."""
    data, _ = _pillow(_image(h, w, seed=6), quality=90)
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(UnsupportedImageError, match=r"no marker \(EOI\) after their scan"):
            decode(data[:-2])


def test_a_broken_stream_raises_a_value_error():
    data, _ = _pillow(_image(64, 64, seed=2), quality=90)
    for broken in (data[:len(data) // 2], data[:2], b"\xff\xd8\xff\xd9"):
        for decode in (jpeg.decode, jpeg.decode_native):
            with pytest.raises(ValueError) as e:
                decode(broken)
            assert not isinstance(e.value, UnsupportedImageError)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    data, _ = _pillow(_image(16, 16, seed=4), quality=90)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    monkeypatch.setattr(_build, "jpeg_library_path", lambda: tmp_path / "libicat_jpeg-x.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    jpeg._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found.*the JPEG decoder"):
            read_pixels(str(path))
    finally:
        jpeg._native.cache_clear()
