"""The inputs of slice 18 on the CPU, against Pillow 12.1.0 and the JAX
package: GIF, animated WebP, palette, RLE and bitfield BMPs, and
RGB-coded, YCCK and other-sampling JPEGs.

* GIF first frames (``io/gif.py``, ``csrc/gif.cc``): Pillow's files,
  interlaced or not, with transparency, a local colour table, a frame
  offset on a larger screen or past a smaller one, gray ramp tables
  (mode ``L``), and LZW streams ``make_inputs.write_gif`` writes with no
  leading clear code, with a deferred clear (a full table kept) and with
  minimum code sizes 2 to 8: Pillow's pixels and mode;
* animated WebPs (``io/webp.py``, ``csrc/webp.cc``): the first frame,
  lossy, lossless or with alpha, offset on its canvas: Pillow's pixels
  and mode;
* BMPs (``io/bmp.py``): 1-, 4- and 8-bit palettes (core headers, top-down,
  gray ramps that open as ``L`` or ``1``), RLE8 and RLE4 of every escape
  and random code streams, 16-bit and every bitfield layout Pillow reads:
  Pillow's pixels and mode, and a plain ``ValueError`` wherever Pillow
  raises;
* JPEGs (``io/jpeg.py`` and ``csrc/jpeg.cc``, bit-equal): RGB-coded by
  Adobe transform 0 or by component ids, YCCK (transforms 1 and 2), and
  samplings 4:4:0, 4:1:1, 3x2, 4x2 and chroma factors other than 1x1:
  Pillow's pixels; fractional samplings raise ``ValueError`` as Pillow
  does, as do the markers after a one-scan file's scan that libjpeg
  refuses (another scan, a frame, SOI, a reserved code);
* every slice-18 file of ``tests/data/inputs``: ``read_image`` equals JAX's
  ``read_image`` (atol 0) where Pillow's mode is ``L``, ``RGB`` or
  ``RGBA``, and elsewhere raises naming the kind, the format and the mode;
* ``image_folder_batches`` on a folder of the new BMPs, animated WebPs and
  JPEGs: JAX's stream, element for element, over two epochs; a classifier
  folder of TIFFs and GIFs: JAX's batches;
* seeded cut and byte-flipped files: wherever Pillow raises, the port
  raises ``ValueError`` (GIF and BMP: where both read, equal pixels);
* a TIFF or GIF decoder that cannot be built raises; nothing falls back.
"""

import importlib
import importlib.util
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.cli import classifier_train
from imagecompression_adversarial_tpu_torch.io import bmp, gif, jpeg, tiff, webp
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.kernels import _build
from imagecompression_adversarial_tpu_torch.train import data

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)
_gif = make_inputs.write_gif
with open(os.path.join(INPUTS, "inputs.json")) as _f:
    TAIL = {n: r for n, r in json.load(_f).items() if n.startswith(make_inputs.TAIL_FILES)}

H, W = 29, 43
FORMATS = {".bmp": "BMP", ".tif": "TIFF", ".gif": "GIF", ".webp": "WebP", ".jpg": "JPEG"}
KINDS = {"P": "palette", "PA": "palette+alpha", "1": "1-bit", "LA": "gray+alpha",
         "I;16": "16-bit gray", "I;16B": "16-bit gray", "CMYK": "CMYK"}


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


def _smooth(h, w, seed, channels=3, noise=0.3):
    return make_inputs.smooth(h, w, seed, channels=channels, noise=noise).astype(np.uint8)


# ---- GIF

def _gif_case(case: str) -> bytes:
    rng = np.random.RandomState(len(case))
    idx = _smooth(H, W, 5, channels=1, noise=0.5)[..., 0] % 64
    table = bytes(rng.randint(0, 256, 3 * 64).astype(np.uint8))
    if case == "pillow-interlaced":
        buf = io.BytesIO()
        Image.fromarray(_smooth(H, W, 6)).convert("P", palette=Image.Palette.ADAPTIVE).save(
            buf, format="GIF", interlace=True, transparency=7)
        return buf.getvalue()
    if case == "pillow-animated":
        buf = io.BytesIO()
        frames = [Image.fromarray(_smooth(H, W, s)) for s in (7, 8)]
        frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:])
        return buf.getvalue()
    if case == "local-interlaced-transparent":
        return _gif(idx, 6, table, local=True, interlace=True, transparency=9)
    if case == "offset-on-larger-screen":
        return _gif(idx, 6, table, screen=(W + 20, H + 9), offset=(13, 5), transparency=3)
    if case == "past-a-smaller-screen":
        return _gif(idx, 6, table, screen=(20, 10), offset=(7, 4), junk=True)
    if case == "gray-ramp-table":
        return _gif(idx, 6, bytes(np.repeat(np.arange(64, dtype=np.uint8), 3)))
    if case == "indices-past-the-table":
        return _gif(idx, 6, table[:3 * 16])
    if case == "no-leading-clear":
        return _gif(idx, 6, table, first_clear=False)
    if case.startswith("deferred-clear"):
        big = rng.randint(0, 256, (90, 120))
        return _gif(big, 8, bytes(rng.randint(0, 256, 768).astype(np.uint8)), clear_at_full=False)
    if case.startswith("code-size-"):
        bits = int(case[-1])
        small = rng.randint(0, 1 << bits, (H, W))
        return _gif(small, bits, bytes(rng.randint(0, 256, 3 << bits).astype(np.uint8)),
                    interlace=bits % 2 == 0)
    raise KeyError(case)


GIF_CASES = ["pillow-interlaced", "pillow-animated", "local-interlaced-transparent",
             "offset-on-larger-screen", "past-a-smaller-screen", "gray-ramp-table",
             "indices-past-the-table", "no-leading-clear", "deferred-clear",
             *(f"code-size-{b}" for b in (2, 3, 5, 8))]


@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_first_frames_give_pillows_pixels_and_mode(case):
    data = _gif_case(case)
    want, mode = _pillow(data)
    parsed = gif.parse(data)
    assert parsed.mode == mode
    np.testing.assert_array_equal(gif.decode_gif_native(parsed), want)


# ---- animated WebP

def _anim(frames, **kwargs) -> bytes:
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=60,
                   **kwargs)
    return buf.getvalue()


def _webp_case(case: str) -> bytes:
    rgb = [Image.fromarray(_smooth(H, W, s)) for s in (21, 22)]
    rgba = [Image.fromarray(_smooth(H, W, s, channels=4), "RGBA") for s in (23, 24)]
    if case == "lossy":
        return _anim(rgb, quality=60)
    if case == "lossless":
        return _anim(rgb, lossless=True)
    if case == "lossy-alpha":
        return _anim(rgba, quality=60, alpha_quality=70)
    if case == "lossless-alpha":
        return _anim(rgba, lossless=True)
    data = bytearray(_anim(rgb, quality=60))  # the first frame at (10, 6) on a wider canvas
    at, vp8x = data.index(b"ANMF"), data.index(b"VP8X")
    data[at + 8:at + 14] = (5).to_bytes(3, "little") + (3).to_bytes(3, "little")
    data[vp8x + 12:vp8x + 18] = (W + 15).to_bytes(3, "little") + (H + 8).to_bytes(3, "little")
    return bytes(data)


@pytest.mark.parametrize("case", ["lossy", "lossless", "lossy-alpha", "lossless-alpha", "offset"])
def test_animated_webps_give_pillows_first_frame_and_mode(tmp_path, case):
    data = _webp_case(case)
    want, mode = _pillow(data)
    parsed = webp.parse(data)
    assert parsed.mode == mode and parsed.canvas == want.shape[1::-1]
    path = tmp_path / "x.webp"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_pixels(str(path)), want)
    got, jax = read_image(str(path)), j_read_image(str(path))
    np.testing.assert_array_equal(got[0], jax[0])


def test_broken_animations_raise_where_pillow_does():
    data = _webp_case("lossy")
    anim, anmf, vp8x = data.index(b"ANIM"), data.index(b"ANMF"), data.index(b"VP8X")
    past = bytearray(data)
    past[anmf + 8:anmf + 11] = (30).to_bytes(3, "little")  # the frame past the canvas
    no_flag = bytearray(data)
    no_flag[vp8x + 8] &= ~0x02
    for broken in (bytes(past), data[:anim] + b"JUNK" + data[anim + 4:], bytes(no_flag)):
        with pytest.raises(OSError):
            _pillow(broken)
        with pytest.raises(ValueError):
            webp.decode_native(broken)


# ---- BMP

def _masks_bmp(bits: int, masks, header: int) -> bytes:
    rng = np.random.RandomState(bits + header)
    v = rng.randint(0, 1 << min(bits, 31), (H, W)).astype(np.int64)
    if bits == 32:
        v = v | (rng.randint(0, 2, (H, W)) << 31)
    return make_inputs.write_bmp(v, bits, 3, masks=masks, header=header)


BMP_MASKS = [key for key in bmp._MASKS]


def _bmp_case(case: str) -> bytes:
    rng = np.random.RandomState(sum(map(ord, case)))
    idx8 = rng.randint(0, 256, (H, W))
    pal = bytes(rng.randint(0, 256, 1024).astype(np.uint8))
    if case.startswith("masks-"):
        bits, masks = BMP_MASKS[int(case[6:])]
        return _masks_bmp(bits, masks, 124 if len(masks) == 4 and any(masks) else 40)
    if case == "palette1-top-down":
        return make_inputs.write_bmp(idx8 % 2, 1, palette=pal[:8], top_down=True)
    if case == "palette4-core":
        return make_inputs.write_bmp(idx8 % 16, 4, palette=pal[:48], header=12)
    if case == "palette8-short-table":
        return make_inputs.write_bmp(idx8, 8, palette=pal[:4 * 40])
    if case == "gray-ramp-8":
        return make_inputs.write_bmp(idx8, 8, palette=b"".join(bytes((i, i, i, 0)) for i in range(256)))
    if case == "black-white-1":
        return make_inputs.write_bmp(idx8 % 2, 1, palette=b"\0\0\0\0\xff\xff\xff\0")
    if case == "rgb555":
        return make_inputs.write_bmp(rng.randint(0, 1 << 16, (H, W)), 16, header=56)
    if case.startswith("rle"):
        rle4 = case.startswith("rle4")
        idx = _smooth(H, W, 9, channels=1, noise=0.2)[..., 0].astype(np.int64) % (16 if rle4 else 256)
        codes = make_inputs.rle_codes(idx, rle4, delta_row=3)
        if case.endswith("random"):  # random codes: Pillow's decoder reads what it can
            codes = bytes(rng.randint(0, 256, 4 * H * W).astype(np.uint8) % 7)
        return make_inputs.write_bmp(idx, 4 if rle4 else 8, 2 if rle4 else 1,
                                     pal[:64] if rle4 else pal, rle=codes)
    raise KeyError(case)


BMP_CASES = ["palette1-top-down", "palette4-core", "palette8-short-table", "gray-ramp-8",
             "black-white-1", "rgb555", "rle8", "rle4", "rle8-random", "rle4-random",
             *(f"masks-{i}" for i in range(len(BMP_MASKS)))]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmps_give_pillows_pixels_and_mode(case):
    data = _bmp_case(case)
    try:
        want, mode = _pillow(data)
    except (OSError, ValueError) as e:  # Pillow refuses: so does the port, plainly
        assert case.endswith("random"), e
        with pytest.raises(ValueError) as got:
            bmp.decode(data)
        assert not isinstance(got.value, UnsupportedImageError)
        return
    got, got_mode = bmp.decode(data)
    assert got_mode == mode
    np.testing.assert_array_equal(got, want)


# ---- JPEG

def _jpeg_case(case: str) -> bytes:
    rgb = _smooth(H, W, 31)
    ycc = jpeg.rgb_to_ycbcr(rgb)
    planes = [ycc[..., i] for i in range(3)]
    if case == "keep-rgb":
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG", quality=85, keep_rgb=True)
        return buf.getvalue()
    if case == "rgb-ids":
        return make_inputs.encode_jpeg([rgb[..., i] for i in range(3)], [(1, 1)] * 3,
                                       ids=[82, 71, 66], jfif=False)
    if case.startswith("ycck"):
        cmyk = _smooth(H, W, 32, channels=4)
        y = jpeg.rgb_to_ycbcr(255 - cmyk[..., :3])
        return make_inputs.encode_jpeg([y[..., 0], y[..., 1], y[..., 2], cmyk[..., 3]],
                                       [(2, 1), (1, 1), (1, 1), (2, 1)], adobe=int(case[-1]),
                                       jfif=False)
    sampling = {"440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
                "3x2": [(3, 2), (1, 1), (1, 1)], "4x2": [(4, 2), (1, 1), (1, 1)],
                "chroma-2x2-1x2": [(2, 2), (2, 2), (1, 2)], "1x4": [(1, 4), (1, 2), (1, 1)],
                "fractional": [(3, 1), (2, 1), (1, 1)]}[case]
    return make_inputs.encode_jpeg(planes, sampling, quality=85)


JPEG_CASES = ["keep-rgb", "rgb-ids", "ycck2", "ycck1", "440", "411", "3x2", "4x2",
              "chroma-2x2-1x2", "1x4"]


@pytest.mark.parametrize("case", JPEG_CASES)
def test_jpeg_kinds_both_decoders_give_pillows_pixels(case):
    data = _jpeg_case(case)
    want, _ = _pillow(data)
    np.testing.assert_array_equal(jpeg.decode_native(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)


def test_fractional_sampling_raises_as_pillow_does():
    data = _jpeg_case("fractional")
    with pytest.raises(OSError):
        _pillow(data)
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(ValueError, match="libjpeg does not upsample by a fraction") as e:
            decode(data)
        assert not isinstance(e.value, UnsupportedImageError)


def _trailer_case(case: str) -> bytes:
    """A baseline file with ``case`` between its scan and its EOI."""
    data = jpeg.encode(_smooth(16, 24, 33), 80)
    end, sos = len(data) - 2, data.index(b"\xff\xda")
    dht = data.index(b"\xff\xc4")
    sof = data.index(b"\xff\xc0")
    tail = {"second-scan": data[sos:end], "huffman-table": data[dht:dht + 33],
            "reserved-marker": b"\xff\x64", "app-segment": b"\xff\xe5\x00\x04ab",
            "rst-marker": b"\xff\xd3", "frame": data[sof:sof + 19], "stray-bytes": b"\x12\x34",
            "soi": b"\xff\xd8", "stuffed-zero": b"\xff\x00"}
    if case == "cut-app-segment":
        return data[:end] + b"\xff\xe5\x00\x10ab"
    return data[:end] + tail[case] + b"\xff\xd9"


@pytest.mark.parametrize("case", ["second-scan", "huffman-table", "reserved-marker",
                                  "app-segment", "rst-marker", "frame", "stray-bytes", "soi",
                                  "stuffed-zero", "cut-app-segment"])
def test_markers_after_a_one_pass_scan_are_read_as_libjpeg_reads_them(case):
    """libjpeg reads a one-scan file's markers to EOI after its rows: where
    that errs, Pillow raises and so does the port, plainly; where it skips
    them, both give the pixels."""
    data = _trailer_case(case)
    try:
        want = _pillow(data)[0]
    except OSError:
        for decode in (jpeg.decode, jpeg.decode_native):
            with pytest.raises(ValueError, match="where libjpeg expects EOI") as e:
                decode(data)
            assert not isinstance(e.value, UnsupportedImageError)
        return
    np.testing.assert_array_equal(jpeg.decode_native(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)


# ---- the committed files, read_image, the stream and the classifier

@pytest.mark.parametrize("name", sorted(TAIL))
def test_read_image_equals_jax_or_names_the_kind(name):
    path = os.path.join(INPUTS, name)
    mode = TAIL[name]["mode"]
    if mode in ("L", "RGB", "RGBA"):
        got, want = read_image(path), j_read_image(path)
        assert got[1:] == want[1:] == tuple(TAIL[name]["shape"][:2])
        np.testing.assert_array_equal(got[0], want[0])
        return
    fmt = FORMATS[os.path.splitext(name)[1]]
    with pytest.raises(UnsupportedImageError,
                       match=f"a {re.escape(KINDS[mode])} {fmt} \\(Pillow's mode {re.escape(mode)}\\)"):
        read_image(path)


def test_a_folder_of_the_new_kinds_streams_as_jax(tmp_path):
    names = [n for n in TAIL if n.endswith((".bmp", ".webp", ".jpg"))]
    for i, name in enumerate(sorted(names)):
        os.makedirs(tmp_path / "ab"[i % 2], exist_ok=True)
        shutil.copy(os.path.join(INPUTS, name), tmp_path / "ab"[i % 2])
    assert data.list_image_files(str(tmp_path)) == j_data.list_image_files(str(tmp_path))
    kw = dict(crop=96, seed=5, workers=2, epochs=2)
    ours = list(data.image_folder_batches(str(tmp_path), 4, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 4, **kw))
    assert len(ours) == len(theirs) == 2 * (len(names) // 4)
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)


def test_classifier_folder_of_tiffs_and_gifs_equals_jax(tmp_path):
    j_cls = importlib.import_module("imagecompression_adversarial_tpu.cli.classifier_train")
    names = sorted(n for n in TAIL if n.endswith((".tif", ".gif")) and "textured" not in n)
    for i, name in enumerate(names):
        os.makedirs(tmp_path / ("cat", "dog")[i % 2], exist_ok=True)
        shutil.copy(os.path.join(INPUTS, name), tmp_path / ("cat", "dog")[i % 2])
    ours = classifier_train._image_folder_labeled(str(tmp_path), 6)
    theirs = j_cls._image_folder_labeled(str(tmp_path), 6)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


# ---- damaged files

def _damaged(rng, data: bytes) -> bytes:
    if rng.rand() < 0.3:
        return data[:rng.randint(6, len(data))]
    out = bytearray(data)
    for at in rng.randint(0, len(data), rng.randint(1, 4)):
        out[at] = rng.randint(256)
    return bytes(out)


@pytest.mark.parametrize("kind", ["gif", "bmp", "webp", "jpeg"])
def test_damaged_files_raise_where_pillow_raises(kind):
    """Wherever Pillow raises on a cut or flipped file, the port raises
    ``ValueError``; GIF and BMP, whose decoders follow Pillow's own, give
    Pillow's pixels wherever both read."""
    rng = np.random.RandomState(len(kind))
    files = {"gif": [_gif_case("local-interlaced-transparent"), _gif_case("code-size-3")],
             "bmp": [_bmp_case("rle8"), _bmp_case("rle4"), _bmp_case("masks-3")],
             "webp": [_webp_case("offset"), _webp_case("lossless-alpha")],
             "jpeg": [_jpeg_case("ycck2"), _jpeg_case("411")]}[kind]
    decode = {"gif": gif.decode_native, "bmp": lambda d: bmp.decode(d)[0],
              "webp": webp.decode_native, "jpeg": jpeg.decode_native}[kind]
    for n in range(60):
        broken = _damaged(rng, files[n % len(files)])
        try:
            want = _pillow(broken)[0]
        except Exception:  # noqa: BLE001 (Pillow raises many kinds)
            with pytest.raises(ValueError):
                decode(broken)
            continue
        try:
            got = decode(broken)
        except ValueError:
            continue  # stricter than Pillow: allowed
        if kind in ("gif", "bmp"):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["tiff", "gif"])
def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch, fmt):
    module = {"tiff": tiff, "gif": gif}[fmt]
    name = {"tiff": "tiff_rgb.tif", "gif": "gif_interlaced.gif"}[fmt]
    monkeypatch.setattr(_build, f"{fmt}_library_path", lambda: tmp_path / f"libicat_{fmt}-x.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    module._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=f"g\\+\\+ not found.*the {fmt.upper()} decoder"):
            read_pixels(os.path.join(INPUTS, name))
    finally:
        module._native.cache_clear()
