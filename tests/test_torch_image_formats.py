"""The port's readers of JPEG, BMP and gray images against the JAX package,
which reads every image through PIL, on the CPU:

* ``read_image`` of JPEGs (4:4:4, 4:2:2, 4:2:0, gray), BMPs (24-bit,
  32-bit, top-down) and a gray PNG: the arrays and sizes of JAX's
  ``read_image``, exactly; palette, RLE, bitfield and 16-bit BMPs, an
  animated WebP, a GIF and a Group 4 TIFF, refused in earlier slices,
  give Pillow's pixels or raise where Pillow does, as do an
  arithmetic-coded JPEG and a Netpbm file since slice 20; what the readers
  do not take raises naming it (an old-style JPEG TIFF, a hierarchical
  JPEG), a file of no known format a plain ``ValueError``;
* ``cli.attack_rd -s x.jpg`` (hyper q1 demo weights, 64x64, 5 steps)
  against JAX's CLI on the same file, at the bounds of the PNG CLI tests
  (``tests/test_torch_cli_attacks.py``: vi within 1e-3 dB, bpp rtol 1e-4);
* ``image_folder_batches`` on a folder of PNG, JPEG (gray among them) and
  BMP files, a broken file and one smaller than the crop, and with JPEGs
  that hold junk between two segments and one cut inside its scan: JAX's
  stream, element for element, over two epochs; a JPEG whose scan Pillow
  decodes with a warning raises, naming the file;
* the classifier's labeled folder of JPEG, BMP and PNG files: JAX's
  batches, exactly;
* ``-precision bfloat16`` parses on both CLIs and turns TF32 on for cuBLAS
  and cuDNN, as ``default`` and ``tf32`` do; an unknown value raises.
"""

import importlib
import importlib.util
import io
import os
import re
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.cli import classifier_train
from imagecompression_adversarial_tpu_torch.config import apply_precision, parse_config
from imagecompression_adversarial_tpu_torch.io import jpeg
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels
from imagecompression_adversarial_tpu_torch.train import data
from test_torch_cli_attacks import FLAGS, J_EXTRA, _cli, _same_report
from torch_parity import image, one_torch_thread  # noqa: F401  (an autouse fixture)

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)


def _pixels(h, w, seed):
    return (np.clip(image(seed, h, w)[0], 0, 1) * 255).astype(np.uint8)


def _bmp_top_down(data: bytes) -> bytes:
    """A bottom-up 24-bit BMP rewritten top-down (negative height)."""
    out = bytearray(data)
    offset = struct.unpack("<I", data[10:14])[0]
    w, h = struct.unpack("<ii", data[18:26])
    stride = (w * 3 + 3) & ~3
    rows = [data[offset + i * stride:offset + (i + 1) * stride] for i in range(h)]
    out[offset:offset + stride * h] = b"".join(rows[::-1])
    out[22:26] = struct.pack("<i", -h)
    return bytes(out)


def _ext(kind: str) -> str:
    return ".jpg" if kind.startswith("jpeg") else "." + kind[:3]


def _write(path, rgb, kind):
    """``rgb`` at ``path`` as Pillow writes a file of ``kind``."""
    if kind.startswith("jpeg"):
        sub = {"jpeg444": 0, "jpeg422": 1, "jpeg420": 2}.get(kind)
        im = Image.fromarray(rgb[..., 0], "L") if kind == "jpeg-gray" else Image.fromarray(rgb)
        im.save(path, format="JPEG", quality=85, **({} if sub is None else {"subsampling": sub}))
    elif kind == "bmp24":
        Image.fromarray(rgb).save(path, format="BMP")
    elif kind == "bmp32":
        alpha = np.full(rgb.shape[:2] + (1,), 77, np.uint8)
        Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA").save(path, format="BMP")
    elif kind == "bmp-top-down":
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="BMP")
        with open(path, "wb") as f:
            f.write(_bmp_top_down(buf.getvalue()))
    elif kind == "png-gray":
        Image.fromarray(rgb[..., 0], "L").save(path, format="PNG")
    return str(path)


KINDS = ["jpeg444", "jpeg422", "jpeg420", "jpeg-gray", "bmp24", "bmp32", "bmp-top-down",
         "png-gray"]


@pytest.mark.parametrize("kind", KINDS)
def test_read_image_equals_jax(tmp_path, kind):
    path = _write(tmp_path / f"x{_ext(kind)}", _pixels(45, 67, seed=KINDS.index(kind)), kind)
    got, want = read_image(path), j_read_image(path)
    assert got[1:] == want[1:] == (45, 67)
    np.testing.assert_array_equal(got[0], want[0])


def _bmp_with(data: bytes, offset: int, fmt: str, value: int) -> bytes:
    out = bytearray(data)
    out[offset:offset + struct.calcsize(fmt)] = struct.pack(fmt, value)
    return bytes(out)


def test_what_the_readers_do_not_take_raises_naming_it(tmp_path):
    rgb = _pixels(8, 8, seed=9)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="BMP")
    bmp = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("P").save(buf, format="BMP")
    read = {
        "palette (8-bit) BMPs": buf.getvalue(),
        "RLE8 BMPs": _bmp_with(bmp, 30, "<I", 1),
        "bitfields BMPs": _bmp_with(bmp, 30, "<I", 3),
        "16-bit BMPs": _bmp_with(bmp, 28, "<H", 16),
    }
    for kind, fmt in (("animated WebP images", "WEBP"), ("GIF images", "GIF")):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format=fmt, save_all=True,
                                  append_images=[Image.fromarray(255 - rgb)])
        read[kind] = buf.getvalue()
    path = tmp_path / "x"
    for kind, content in read.items():  # since slice 18: Pillow's pixels, or its refusal
        path.write_bytes(content)
        try:
            with Image.open(io.BytesIO(content)) as im:
                want = np.asarray(im.convert("RGB"))
        except (OSError, ValueError, SyntaxError):
            with pytest.raises(ValueError) as e:
                read_pixels(str(path))
            assert not isinstance(e.value, UnsupportedImageError), kind
            continue
        np.testing.assert_array_equal(read_pixels(str(path)), want, err_msg=kind)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("1").save(buf, format="TIFF", compression="group4")
    read["CCITT Group 4 TIFFs"] = buf.getvalue()  # read since the CCITT decoders
    field = b"\x03\x01\x03\x00\x01\x00\x00\x00"  # Compression, SHORT, 1 value:
    old_jpeg = buf.getvalue().replace(field + b"\x04\x00", field + b"\x06\x00")  # 6
    buf2 = io.BytesIO()
    Image.fromarray(rgb).save(buf2, format="JPEG")
    jpg = bytearray(buf2.getvalue())
    jpg[jpg.index(b"\xff\xc0") + 1] = 0xC5
    named = {"old-style JPEG TIFFs": old_jpeg,
             "hierarchical sequential JPEGs": bytes(jpg)}
    for match, content in named.items():
        path.write_bytes(content)
        with pytest.raises(UnsupportedImageError, match=re.escape(match)):
            read_pixels(str(path))
    arith = make_inputs.encode_arith_jpeg(list(np.moveaxis(jpeg.rgb_to_ycbcr(rgb), -1, 0)),
                                          [(2, 2), (1, 1), (1, 1)], 75)
    for content in (arith, b"P6\n8 8\n255\n" + rgb.tobytes()):  # read since slice 20
        path.write_bytes(content)
        with Image.open(io.BytesIO(content)) as im:
            np.testing.assert_array_equal(read_pixels(str(path)), np.asarray(im.convert("RGB")))
    path.write_bytes(b"XYZW" + rgb.tobytes())
    with pytest.raises(ValueError,
                       match="not a PNG, JPEG, WebP, TIFF, GIF, BMP, Netpbm or JPEG 2000") as e:
        read_pixels(str(path))
    assert not isinstance(e.value, UnsupportedImageError)


def test_attack_rd_cli_on_a_jpeg_matches_jax(tmp_path, capsys):
    j_cli, cli = _cli("attack_rd")
    src = _write(tmp_path / "kodim01.jpg", _pixels(64, 64, seed=63), "jpeg420")
    argv = FLAGS + ["-s", src, "-steps", "5", "-two_phase", "select"]
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    capsys.readouterr()
    _same_report(cli.run(parse_config(argv)), ref)
    assert "kodim01.jpg: bpp_ori" in capsys.readouterr().out


def _mixed_folder(root):
    """PNG, JPEG (one gray), BMP files in two folders, a broken file and
    one smaller than the crop."""
    kinds = ["jpeg420", "bmp24", "jpeg-gray", "jpeg444", "bmp32", "jpeg422"]
    for i, kind in enumerate(kinds):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        _write(sub / f"{i}{_ext(kind)}", _pixels(40 + 3 * i, 50 - 2 * i, seed=20 + i), kind)
    for i in range(2):
        write = _pixels(36 + i, 44, seed=30 + i)
        Image.fromarray(write).save(root / f"p{i}.png")
    Image.fromarray(_pixels(20, 20, seed=40)).save(root / "a" / "small.jpeg")
    (root / "b" / "broken.jpg").write_bytes(b"\xff\xd8\xff\xdb\x00")


def test_mixed_folder_stream_equals_jax(tmp_path):
    _mixed_folder(tmp_path)
    assert data.list_image_files(str(tmp_path)) == j_data.list_image_files(str(tmp_path))
    args = (str(tmp_path), 2)
    kw = dict(crop=32, seed=5, workers=2, epochs=2)
    ours = list(data.image_folder_batches(*args, **kw))
    theirs = list(j_data.image_folder_batches(*args, **kw))
    assert len(ours) == len(theirs) == 8  # 8 readable files an epoch, batches of 2
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)


def _jpeg_segment(data: bytes, code: int) -> int:
    pos = 2
    while data[pos + 1] != code:
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def test_a_folder_with_damaged_jpegs_streams_as_jax(tmp_path):
    """The mixed folder and three JPEGs that Pillow handles on its own
    terms: two with extraneous bytes between two segments (read, the junk
    skipped), one cut inside its scan (Pillow calls it truncated: skipped)."""
    _mixed_folder(tmp_path)
    for name, seed, junk in (("junk0.jpg", 60, b"\x00\x12junk"), ("junk1.jpeg", 61, b"\xff\x00\x33")):
        buf = io.BytesIO()
        Image.fromarray(_pixels(41, 47, seed=seed)).save(buf, format="JPEG", quality=90)
        jpg = buf.getvalue()
        at = _jpeg_segment(jpg, 0xDB)
        (tmp_path / name).write_bytes(jpg[:at] + junk + jpg[at:])
    (tmp_path / "a" / "cut.jpg").write_bytes(jpg[:len(jpg) // 2])
    args = (str(tmp_path), 2)
    kw = dict(crop=32, seed=7, workers=2, epochs=2)
    ours = list(data.image_folder_batches(*args, **kw))
    theirs = list(j_data.image_folder_batches(*args, **kw))
    assert len(ours) == len(theirs) == 10  # 10 readable files an epoch, batches of 2
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)


def test_a_folder_with_a_corrupt_jpeg_scan_raises_naming_the_file(tmp_path):
    """A bad Huffman code in a scan that EOI ends: Pillow decodes it with
    libjpeg's warning, so JAX's stream holds the file, and the port raises
    instead of skipping it."""
    buf = io.BytesIO()
    Image.fromarray(_pixels(40, 40, seed=62)).save(buf, format="JPEG", quality=90)
    jpg = buf.getvalue()
    at = _jpeg_segment(jpg, 0xDA)
    s0 = at + 2 + struct.unpack(">H", jpg[at + 2:at + 4])[0]
    (tmp_path / "bad.jpg").write_bytes(jpg[:s0 + 40] + b"\xff\x00" * 3 + jpg[s0 + 46:])
    args, kw = (str(tmp_path), 1), dict(crop=32, seed=0, workers=1, epochs=1)
    assert len(list(j_data.image_folder_batches(*args, **kw))) == 1
    with pytest.raises(UnsupportedImageError, match=r"bad\.jpg: corrupt JPEG scan"):
        list(data.image_folder_batches(*args, **kw))


def test_classifier_folder_of_jpegs_equals_jax(tmp_path):
    j_cls = importlib.import_module("imagecompression_adversarial_tpu.cli.classifier_train")
    for label, kinds in (("cat", ["jpeg420", "jpeg-gray", "bmp24"]),
                         ("dog", ["jpeg444", "jpeg422", "png-gray"])):
        os.makedirs(tmp_path / label)
        for i, kind in enumerate(kinds):
            rgb = _pixels(33 + 5 * i, 41, seed=50 + i)
            _write(tmp_path / label / f"{i}{_ext(kind)}", rgb, kind)
    ours = classifier_train._image_folder_labeled(str(tmp_path), 4)
    theirs = j_cls._image_folder_labeled(str(tmp_path), 4)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


def test_precision_bfloat16_selects_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for value, tf32 in (("bfloat16", True), ("highest", False), ("default", True),
                            ("float32", False), ("tf32", True)):
            cfg = parse_config(["-precision", value])
            assert j_parse_config(["-precision", value]).precision == cfg.precision == value
            apply_precision(cfg)
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
        with pytest.raises(ValueError, match="unknown precision 'fp8'"):
            apply_precision(parse_config(["-precision", "fp8"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
