"""The port's PNG reader and writer (``io/image.py``, ``io/png.py``), with
PIL blocked.

The port reads PNGs with ``zlib`` and its host C++ decoder, writes them
with numpy and ``zlib``, and needs no PIL.
Every call into the port here runs with ``sys.modules["PIL"] = None``, so an
import of PIL inside it fails.  PIL, where the host has it, only makes
reference files and decodes the port's output; where it is missing those
cases skip.  Pixels must match exactly.  Runs on the card too:
``python -m pytest tests/test_torch_image.py -q --noconftest``.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from imagecompression_adversarial_tpu_torch.cli import attack_rd
from imagecompression_adversarial_tpu_torch.config import parse_config
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels, write_image

_COLOUR = {"gray": (0, 1, "L"), "rgb": (2, 3, "RGB"), "rgba": (6, 4, "RGBA")}


@pytest.fixture
def pil():
    return pytest.importorskip("PIL.Image", reason="PIL makes the reference files")


@pytest.fixture
def no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)


def _pixels(h, w, channels, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, channels)).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _as_rgb(img):
    """What ``read_image`` makes of 8-bit pixels: float RGB in [0, 1]."""
    out = img.astype(np.float32) / 255.0
    if out.ndim == 2:
        out = np.tile(out[..., None], (1, 1, 3))
    return out[..., :3]


def _png(w, h, colour, raw, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter(lines, bpp):
    """PNG's five scanline filters, byte by byte; row y gets type (y + 2) % 5,
    so the first row (whose upper neighbours are zero) is Up."""
    out = bytearray()
    for y, line in enumerate(lines.astype(int)):
        kind = (y + 2) % 5
        out.append(kind)
        for i, v in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = lines[y - 1, i] if y else 0
            c = lines[y - 1, i - bpp] if y and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((v - int(pred)) % 256)
    return bytes(out)


@pytest.mark.parametrize("mode", ["gray", "rgb", "rgba"])
def test_reads_pil_written_png(pil, tmp_path, monkeypatch, mode):
    img = _pixels(37, 53, _COLOUR[mode][1], seed=1)
    path = tmp_path / f"{mode}.png"
    pil.fromarray(img, _COLOUR[mode][2]).save(path)
    ref = np.asarray(pil.open(path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        im, h, w = read_image(str(path))
    assert (h, w) == (37, 53) and im.shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(im[0, :h, :w], _as_rgb(ref))
    assert not im[0, h:].any() and not im[0, :, w:].any()


@pytest.mark.parametrize("mode", ["gray", "rgb", "rgba"])
def test_reads_each_scanline_filter(no_pil, tmp_path, mode):
    colour, bpp, _ = _COLOUR[mode]
    img = _pixels(10, 9, bpp, seed=2)
    path = tmp_path / "filtered.png"
    path.write_bytes(_png(9, 10, colour, _filter(img.reshape(10, -1), bpp)))
    im, h, w = read_image(str(path), padding=1)
    assert (h, w) == (10, 9)
    np.testing.assert_array_equal(im[0], _as_rgb(img))


def test_hand_filtered_png_is_what_pil_reads(pil, tmp_path):
    img = _pixels(10, 9, 3, seed=2)
    path = tmp_path / "filtered.png"
    path.write_bytes(_png(9, 10, 2, _filter(img.reshape(10, -1), 3)))
    np.testing.assert_array_equal(np.asarray(pil.open(path)), img)


def test_written_png_reads_back_through_pil(pil, tmp_path, monkeypatch):
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    path = tmp_path / "out.png"
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        write_image(x, str(path), 45, 61)
        back, h, w = read_image(str(path), padding=1)
    expect = np.clip(np.round(x[0, :45, :61] * 255.0), 0, 255).astype(np.uint8)
    with pil.open(path) as f:
        assert f.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(f), expect)
    assert (h, w) == (45, 61)
    np.testing.assert_array_equal(back[0], expect.astype(np.float32) / 255.0)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _interlaced(img, bpp):
    """Adam7's seven passes of (h, w, bpp) pixels, each filtered as
    ``_filter`` filters an image."""
    passes = (img[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7)
    return b"".join(_filter(p.reshape(p.shape[0], -1), bpp) for p in passes if p.size)


@pytest.mark.parametrize("feature", ["palette", "16-bit", "interlaced", "crc"])
def test_rejects_what_it_does_not_read(pil, tmp_path, monkeypatch, feature):
    """A palette and a 16-bit gray PNG give ``read_pixels`` PIL's
    ``convert("RGB")``, and ``read_image`` refuses them naming PIL's mode
    (JAX's ``read_image`` takes their palette indices or raw 16-bit values
    as pixels); an interlaced RGB PNG reads as PIL reads it; a fault in a
    chunk's CRC raises."""
    path = tmp_path / f"{feature}.png"
    if feature == "palette":
        pil.fromarray(_pixels(8, 8, 3, seed=4), "RGB").convert("P").save(path)
    elif feature == "16-bit":
        pil.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    elif feature == "interlaced":
        path.write_bytes(_png(13, 11, 2, _interlaced(_pixels(11, 13, 3, seed=4), 3), interlace=1))
    else:
        data = bytearray(_png(2, 2, 2, bytes(14)))
        data[-20] ^= 1  # a byte of the IDAT body
        path.write_bytes(bytes(data))
    want = None if feature == "crc" else np.asarray(pil.open(path).convert("RGB"))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        if feature == "crc":
            with pytest.raises(ValueError, match="CRC"):
                read_image(str(path))
        elif feature == "interlaced":
            im, h, w = read_image(str(path), padding=1)
            assert (h, w) == (11, 13)
            np.testing.assert_array_equal(im[0], _as_rgb(want))
        else:
            np.testing.assert_array_equal(read_pixels(str(path)), want)
            mode = {"palette": "P", "16-bit": "I;16"}[feature]
            with pytest.raises(UnsupportedImageError, match=f"Pillow's mode {mode}"):
                read_image(str(path))


def test_cli_debug_pngs_without_pil(no_pil, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    write_image(np.random.RandomState(5).rand(1, 40, 48, 3), str(tmp_path / "kodim01.png"))
    cfg = parse_config(["-m", "hyper", "-q", "1", "-metric", "mse", "-device", "cpu", "--new",
                        "-steps", "2", "-s", str(tmp_path / "*.png"), "--debug"])
    attack_rd.run(cfg)
    for kind in ("advin", "advout", "noise"):
        im, h, w = read_image(str(tmp_path / "attack" / "results" / f"hyper_1_mse_kodim01_{kind}.png"))
        assert (h, w) == (40, 48) and im.shape == (1, 64, 64, 3)
        assert np.isfinite(im).all()
