"""Every image kind the JAX package reads through PIL and the port reads
since slice 16, on the CPU, against Pillow 12.1.0 and the JAX package:

* each PNG kind (every bit depth of every colour type, plain and
  Adam7-interlaced, palettes with indices past their PLTE) and each JPEG
  kind beyond baseline (progressive gray and YCbCr at 4:4:4, 4:2:2 and
  4:2:0, with restart intervals; CMYK, baseline, progressive and without
  its Adobe marker; a sequential file of one scan a component): the host
  C++ decoders (``csrc/png.cc``, ``csrc/jpeg.cc``) and their numpy plain
  versions bit-equal to each other and to Pillow's ``convert("RGB")``;
* ``read_image`` equal to JAX's ``read_image`` wherever Pillow's mode is
  ``L``, ``RGB`` or ``RGBA``, and raising ``UnsupportedImageError`` naming
  the mode (``P``, ``1``, ``LA``, ``I;16``, ``CMYK``) elsewhere;
* a folder of every kind: JAX's ``image_folder_batches`` element for
  element over two epochs at the same seed, then again with a lossy, a
  lossless and an RGBA WebP in it, an animated one (since slice 18), and
  an arithmetic-coded and a lossless JPEG (since slice 20), and a
  hierarchical JPEG, which Pillow refuses and both streams skip; a
  lossless JPEG of subsampled components, which Pillow reads, raises,
  naming itself;
* the classifier's labeled folder of progressive JPEGs and palette PNGs:
  JAX's batches;
* a progressive file whose last scans are gone (Pillow smooths its
  blocks) and progressions libjpeg warns of raise naming it; multi-scan
  files cut before EOI, and a Huffman table that uses an all-ones code,
  raise a plain ``ValueError`` where Pillow raises;
* a PNG decoder that cannot be built raises, and nothing falls back;
* every committed file of ``tests/data/inputs`` (``make_inputs.py``) is
  still the pixels its ``inputs.json`` records for Pillow, and the C++
  decoders give them.

Files are at most 96x64, made with numpy from seeds.
"""

import hashlib
import importlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.cli import classifier_train
from imagecompression_adversarial_tpu_torch.io import jpeg, png
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.kernels import _build
from imagecompression_adversarial_tpu_torch.train import data

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)

H, W = 45, 61


def _rgb(h, w, seed):
    return make_inputs.smooth(h, w, seed, noise=0.3).astype(np.uint8)


def _png_kind(depth, colour, interlace, h=H, w=W, seed=0):
    """A PNG of random samples; a palette of 11 entries under indices up
    to 15 (or 1 at 1 bit), so that some lie past its PLTE."""
    rng = np.random.RandomState(seed + depth + 7 * colour + 50 * interlace)
    samples = rng.randint(0, 1 << depth, (h, w, png.CHANNELS[colour]))
    palette = b""
    if colour == 3:
        samples %= min(1 << depth, 16)
        palette = bytes(rng.randint(0, 256, 33).astype(np.uint8))
    return make_inputs.write_png(samples, depth, colour, interlace, palette, seed=seed)


def _pillow_rgb(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth, colour", list(png.MODES))
def test_png_kinds_decode_to_pillows_pixels(depth, colour, interlace):
    for seed, (h, w) in enumerate(((H, W), (1, 1), (9, 2), (64, 96))):
        data = _png_kind(depth, colour, interlace, h, w, seed)
        want, mode = _pillow_rgb(data)
        assert mode == png.MODES[(depth, colour)]
        np.testing.assert_array_equal(png.decode_native(data), want)
        np.testing.assert_array_equal(png.decode(data), want)


def _pillow_jpeg(img, **kwargs) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _segment(data: bytes, code: int) -> int:
    """The offset of the first marker segment ``0xFF code``."""
    pos = 2
    while data[pos + 1] != code:
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return pos


def _without(data: bytes, code: int) -> bytes:
    at = _segment(data, code)
    return data[:at] + data[at + 2 + int.from_bytes(data[at + 2:at + 4], "big"):]


def _scan_per_component(rgb, quality=75) -> bytes:
    """A baseline JPEG of ``rgb`` at 4:2:0 in three scans of one
    component each (Y, Cb, Cr), each over its component's own block grid
    in raster order: the port's encoder's quantized blocks and tables."""
    h, w, _ = rgb.shape
    mr, mc = -(-h // 16), -(-w // 16)
    ycc = jpeg.rgb_to_ycbcr(rgb)
    q_luma, q_chroma = jpeg.quant_tables(quality)
    luma = jpeg._repeat_edges(ycc[..., 0], 16 * mr, 16 * mc)
    planes = [jpeg.quantize(jpeg.fdct(jpeg._blocks(luma) - 128), q_luma)[:-(-h // 8), :-(-w // 8)]]
    for i in (1, 2):
        full = jpeg._repeat_edges(ycc[..., i], h + h % 2, 16 * mc)
        half = jpeg._repeat_edges(jpeg.h2v2_downsample(full), 8 * mr, 8 * mc)
        planes.append(jpeg.quantize(jpeg.fdct(jpeg._blocks(half) - 128), q_chroma))
    one_scan = jpeg.encode(rgb, quality)
    out = [one_scan[:one_scan.index(b"\xff\xda")]]  # SOI to the last DHT
    for k, blocks in enumerate(planes):
        zz = blocks.reshape(-1, 64)[:, jpeg.ZIGZAG]
        out.append(jpeg._marker(0xDA, bytes([1, k + 1, 0x11 if k else 0x00, 0, 63, 0])))
        out.append(jpeg._scan(zz, np.full(len(zz), min(k, 1))))
    return b"".join(out) + b"\xff\xd9"


def _jpeg_kind(kind: str, h=H, w=W, seed=0) -> bytes:
    img = Image.fromarray(_rgb(h, w, seed))
    if kind.startswith("progressive-"):
        sub = kind.split("-", 1)[1]
        if sub == "gray":
            return _pillow_jpeg(img.convert("L"), quality=85, progressive=True)
        if sub == "restarts":
            return _pillow_jpeg(img, quality=85, progressive=True, restart_marker_blocks=3)
        return _pillow_jpeg(img, quality=85, progressive=True,
                            subsampling={"444": 0, "422": 1, "420": 2}[sub])
    if kind == "sequential-scans":
        return _scan_per_component(np.asarray(img))
    cmyk = img.convert("CMYK")
    if kind == "cmyk":
        return _pillow_jpeg(cmyk, quality=85)
    if kind == "cmyk-progressive":
        return _pillow_jpeg(cmyk, quality=85, progressive=True)
    return _without(_pillow_jpeg(cmyk, quality=85), 0xEE)  # cmyk-no-adobe


JPEG_KINDS = ["progressive-444", "progressive-422", "progressive-420", "progressive-gray",
              "progressive-restarts", "cmyk", "cmyk-progressive", "cmyk-no-adobe",
              "sequential-scans"]


@pytest.mark.parametrize("kind", JPEG_KINDS)
def test_jpeg_kinds_decode_to_pillows_pixels(kind):
    for seed, (h, w) in enumerate(((H, W), (1, 1), (17, 2), (64, 96))):
        data = _jpeg_kind(kind, h, w, seed)
        want, mode = _pillow_rgb(data)
        assert mode == ("CMYK" if kind.startswith("cmyk") else "L" if "gray" in kind else "RGB")
        for decode in (jpeg.decode_native, jpeg.decode):
            got = decode(data)
            np.testing.assert_array_equal(np.repeat(got, 3, 2) if got.shape[2] == 1 else got,
                                          want)
    if kind == "sequential-scans":  # the same blocks as the one-scan file's
        rgb = _rgb(H, W, 0)
        np.testing.assert_array_equal(jpeg.decode_native(_jpeg_kind(kind)),
                                      _pillow_rgb(jpeg.encode(rgb, 75))[0])


# the files read_image takes (Pillow's L, RGB, RGBA) and those it refuses
READ = {"png-gray2": (2, 0, 0), "png-gray4-interlaced": (4, 0, 1), "png-gray8": (8, 0, 1),
        "png-rgb16": (16, 2, 0), "png-rgba16-interlaced": (16, 6, 1), "png-graya16": (16, 4, 0),
        "png-rgb-interlaced": (8, 2, 1), "jpeg-progressive-420": "progressive-420",
        "jpeg-progressive-gray": "progressive-gray", "jpeg-sequential-scans": "sequential-scans"}
REFUSED = {"png-palette": ((8, 3, 0), "P"), "png-palette2-interlaced": ((2, 3, 1), "P"),
           "png-gray1": ((1, 0, 0), "1"), "png-graya": ((8, 4, 0), "LA"),
           "png-gray16": ((16, 0, 1), "I;16"), "jpeg-cmyk": ("cmyk", "CMYK")}


def _kind_file(path, spec, seed=0, h=H, w=W) -> str:
    path = str(path)
    with open(path, "wb") as f:
        f.write(_png_kind(*spec, h, w, seed) if isinstance(spec, tuple)
                else _jpeg_kind(spec, h, w, seed))
    return path


@pytest.mark.parametrize("name", list(READ) + list(REFUSED))
def test_read_image_equals_jax_or_names_the_mode(tmp_path, name):
    spec = READ.get(name) or REFUSED[name][0]
    path = _kind_file(tmp_path / f"x.{name[:name.index('-')]}", spec)
    if name in READ:
        got, want = read_image(path), j_read_image(path)
        assert got[1:] == want[1:] == (H, W)
        np.testing.assert_array_equal(got[0], want[0])
        return
    mode = REFUSED[name][1]
    with pytest.raises(UnsupportedImageError, match=f"Pillow's mode {re.escape(mode)}"):
        read_image(path)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(read_pixels(path), np.asarray(im.convert("RGB")))


def _every_kind_folder(root):
    """One file of each kind above in two subfolders, each at least the
    32x32 crop."""
    for i, (name, spec) in enumerate([*READ.items(), *((n, s) for n, (s, _) in REFUSED.items()),
                                      ("jpeg-progressive-444", "progressive-444"),
                                      ("jpeg-cmyk-progressive", "cmyk-progressive")]):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        ext = ".jpg" if name.startswith("jpeg") else ".png"
        _kind_file(sub / f"{name}{ext}", spec, seed=i, h=36 + 3 * (i % 5), w=48 - 2 * (i % 4))


def test_a_folder_of_every_kind_streams_as_jax(tmp_path):
    _every_kind_folder(tmp_path)
    assert data.list_image_files(str(tmp_path)) == j_data.list_image_files(str(tmp_path))
    kw = dict(crop=32, seed=11, workers=2, epochs=2)
    ours = list(data.image_folder_batches(str(tmp_path), 3, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 3, **kw))
    assert len(ours) == len(theirs) == 12  # 18 files an epoch, batches of 3
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)
    # a lossy, a lossless and an RGBA WebP join it; an animated one raises
    Image.fromarray(_rgb(40, 38, 9)).save(tmp_path / "a" / "lossy.webp", quality=60)
    Image.fromarray(_rgb(34, 41, 10)).save(tmp_path / "b" / "lossless.webp", lossless=True)
    Image.fromarray(make_inputs.smooth(37, 36, 11, channels=4, noise=0.3).astype(np.uint8),
                    "RGBA").save(tmp_path / "b" / "rgba.webp", quality=70)
    ours = list(data.image_folder_batches(str(tmp_path), 3, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 3, **kw))
    assert len(ours) == len(theirs) == 14  # 21 files an epoch
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)
    # since slice 18 an animated WebP joins it too
    frames = [Image.fromarray(_rgb(40, 40, s)) for s in (12, 13)]
    frames[0].save(tmp_path / "a" / "z.webp", save_all=True, append_images=frames[1:])
    ours = list(data.image_folder_batches(str(tmp_path), 3, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 3, **kw))
    assert len(ours) == len(theirs) == 14  # 22 files an epoch
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)
    # since slice 20 a progressive arithmetic-coded and a lossless JPEG join it
    ycc = jpeg.rgb_to_ycbcr(_rgb(40, 44, 14))
    (tmp_path / "a" / "x.jpg").write_bytes(make_inputs.encode_arith_jpeg(
        list(np.moveaxis(ycc, -1, 0)), [(2, 2), (1, 1), (1, 1)], 80,
        script=make_inputs.PROGRESSION_3, restart=3))
    (tmp_path / "b" / "x.jpg").write_bytes(make_inputs.encode_lossless_jpeg(
        list(np.moveaxis(_rgb(36, 40, 15), -1, 0)), 6, restart_rows=4))
    # a hierarchical JPEG, which Pillow refuses: both streams skip it
    hierarchical = bytearray(jpeg.encode(_rgb(40, 40, 16), 75))
    hierarchical[hierarchical.index(b"\xff\xc0") + 1] = 0xC5
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bytes(hierarchical))).load()
    (tmp_path / "a" / "w.jpg").write_bytes(bytes(hierarchical))
    ours = list(data.image_folder_batches(str(tmp_path), 3, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 3, **kw))
    assert len(ours) == len(theirs) == 16  # 24 files read an epoch
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)
    # a lossless JPEG of 2x2 luma, which Pillow reads and the port does not, raises
    subsampled = bytearray(make_inputs.encode_lossless_jpeg(
        list(np.moveaxis(_rgb(40, 40, 16), -1, 0)), 1))
    subsampled[subsampled.index(b"\xff\xc3") + 11] = 0x22
    Image.open(io.BytesIO(bytes(subsampled))).load()
    (tmp_path / "a" / "y.jpg").write_bytes(bytes(subsampled))
    with pytest.raises(UnsupportedImageError, match=r"y\.jpg: lossless JPEGs of subsampled "
                                                    r"components .* are not supported"):
        list(data.image_folder_batches(str(tmp_path), 3, **kw))


def test_classifier_folder_of_progressive_jpegs_and_palette_pngs_equals_jax(tmp_path):
    j_cls = importlib.import_module("imagecompression_adversarial_tpu.cli.classifier_train")
    for label, specs in (("cat", ["progressive-420", (8, 3, 0), "progressive-gray"]),
                         ("dog", [(4, 3, 1), "progressive-444", (2, 3, 0)])):
        os.makedirs(tmp_path / label)
        for i, spec in enumerate(specs):
            ext = ".png" if isinstance(spec, tuple) else ".jpg"
            _kind_file(tmp_path / label / f"{i}{ext}", spec, seed=30 + i, h=33 + 5 * i, w=41)
    ours = classifier_train._image_folder_labeled(str(tmp_path), 4)
    theirs = j_cls._image_folder_labeled(str(tmp_path), 4)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


def _scan_starts(data: bytes):
    return [m.start() for m in re.finditer(b"\xff\xda", data)]


def test_an_incomplete_progressive_file_raises_naming_it():
    """Without its last scans (EOI kept) Pillow decodes the file and
    libjpeg-turbo smooths its blocks; both decoders refuse it."""
    full = _jpeg_kind("progressive-420")
    starts = _scan_starts(full)
    for keep in (1, len(starts) - 1):
        cut = full[:starts[keep]] + b"\xff\xd9"
        assert _pillow_rgb(cut)[0].shape == (H, W, 3)
        for decode in (jpeg.decode, jpeg.decode_native):
            with pytest.raises(UnsupportedImageError, match="incomplete progressive JPEGs"):
                decode(cut)


def _bogus(kind: str) -> bytes:
    """A file whose progression libjpeg warns of and decodes: a baseline
    scan of band 0..62, or a progressive AC scan that claims bits already
    sent (Ah 3, Al 2 where nothing was)."""
    data = bytearray(jpeg.encode(_rgb(H, W, 0), 85) if kind == "sequential-band"
                     else _jpeg_kind("progressive-420"))
    at = _scan_starts(bytes(data))[0 if kind == "sequential-band" else 1]
    n = data[at + 4]
    if kind == "sequential-band":
        data[at + 6 + 2 * n] = 62
    else:
        data[at + 7 + 2 * n] = 0x32
    return bytes(data)


@pytest.mark.parametrize("kind", ["sequential-band", "progressive-bits"])
def test_a_progression_libjpeg_warns_of_raises_naming_it(kind):
    data = _bogus(kind)
    assert _pillow_rgb(data)[0].shape == (H, W, 3)
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(UnsupportedImageError, match="progression libjpeg decodes with a "
                                                        "warning"):
            decode(data)


@pytest.mark.parametrize("kind", ["progressive-420", "sequential-scans"])
def test_a_multi_scan_file_cut_before_eoi_raises_a_value_error(kind):
    """libjpeg reads a file of several scans to its EOI before its first
    row: cut inside a scan, between scans or just before EOI, Pillow calls
    it truncated, so JAX's folder reader skips it, and the port's may."""
    full = _jpeg_kind(kind)
    starts = _scan_starts(full)
    for cut in (full[:starts[1] + 40], full[:starts[-1]], full[:-2]):
        with pytest.raises(OSError, match="truncated"):
            _pillow_rgb(cut)
        for decode in (jpeg.decode, jpeg.decode_native):
            with pytest.raises(ValueError, match="truncated") as e:
                decode(cut)
            assert not isinstance(e.value, UnsupportedImageError)


def test_a_huffman_table_with_the_all_ones_code_raises_a_value_error():
    """libjpeg refuses a table that uses a length's all-ones code (two
    codes of one bit), and Pillow raises, so JAX's folder reader skips the
    file: both decoders raise a plain ``ValueError``."""
    data = bytearray(jpeg.encode(_rgb(H, W, 0), 85))
    counts = _segment(bytes(data), 0xC4) + 5  # Annex K's luma DC: 0, 1, 5, 1, ...
    data[counts:counts + 3] = bytes([2, 0, 4])
    with pytest.raises(OSError, match="broken data stream"):
        _pillow_rgb(bytes(data))
    for decode in (jpeg.decode, jpeg.decode_native):
        with pytest.raises(ValueError, match="more codes than its lengths hold") as e:
            decode(bytes(data))
        assert not isinstance(e.value, UnsupportedImageError)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    path = _kind_file(tmp_path / "x.png", (8, 2, 1))
    monkeypatch.setattr(_build, "png_library_path", lambda: tmp_path / "libicat_png-x.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    png._native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found.*the PNG decoder"):
            read_pixels(path)
    finally:
        png._native.cache_clear()


with open(os.path.join(INPUTS, "inputs.json")) as _f:
    FIXTURES = json.load(_f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_committed_fixtures_hold_their_pillow_hashes(name):
    path = os.path.join(INPUTS, name)
    record = FIXTURES[name]
    with Image.open(path) as im:
        assert im.mode == record["mode"]
        want = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    assert list(want.shape) == record["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == record["sha256"]
    np.testing.assert_array_equal(read_pixels(path), want)
