"""TIFF inputs (slice 18) on the CPU, against Pillow 12.1.0 (libtiff for
compressed files, its own raw reader for uncompressed ones) and the JAX
package:

* every key of ``io/tiff.py::OPEN_INFO`` (byte order, photometric
  interpretation, sample format, fill order, bits, extra samples), each in
  one of the layouts and codings ``make_inputs.write_tiff`` writes by turns
  (strips, tiles, planar; none, LZW, PackBits, both Deflates; horizontal
  differencing; BigTIFF): ``read_pixels`` gives Pillow's
  ``convert("RGB")`` bit for bit and ``parse`` Pillow's mode;
  ``read_image`` gives JAX's ``read_image`` where the mode is ``L``,
  ``RGB`` or ``RGBA`` (atol 0), and elsewhere raises naming the kind,
  ``TIFF`` and the mode;
* each EXIF orientation undone as Pillow's ``exif_transpose`` does;
* the kinds left out (old-style JPEG and ThunderScan codings, planar
  16-bit, compressed planar RGBA without ExtraSamples) raise
  ``UnsupportedImageError`` naming them; a layout Pillow has no row for
  raises a plain ``ValueError`` (the JPEG and CCITT codings and the
  32-bit, float, signed and CIELab samples these raised up to slice 18
  are held to Pillow in ``tests/test_torch_tiff_codecs.py``);
* seeded cut and byte-flipped files: wherever Pillow raises, the port
  raises ``ValueError``; where both read, the pixels agree.

Files are at most 37x45, made with numpy from seeds.
"""

import importlib.util
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu_torch.io import tiff
from imagecompression_adversarial_tpu_torch.io.errors import UnsupportedImageError
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)

H, W = 37, 45
KEYS = sorted(tiff.OPEN_INFO, key=repr)
KINDS = {"P": "palette", "PA": "palette+alpha", "1": "1-bit", "LA": "gray+alpha",
         "I;16": "16-bit gray", "I;16B": "16-bit gray", "CMYK": "CMYK"}


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB")), im.mode


def _tiff_of(key, i: int) -> bytes:
    """A TIFF of random samples for ``key``, in the i-th layout and coding."""
    order, photometric, fmt, fill, bits, extra = key
    rng = np.random.RandomState(i)
    spp, b = len(bits), bits[0]
    samples = rng.randint(0, 1 << b, (H, W, spp))
    if extra and extra[0] == 1:  # premultiplied: colour at most alpha
        samples[..., :3] = samples[..., :3] * samples[..., 3:4] // ((1 << b) - 1)
    compression = (1, 5, 32773, 8, 32946)[i % 5]
    layout = i // 5 % 3
    planar = 2 if layout == 2 and b == 8 and spp > 1 else 1
    raw = tiff.OPEN_INFO[key][1]
    if planar == 2 and (raw not in (tiff._PLANAR_RAW if compression == 1 else tiff._PLANAR_LIBTIFF)
                        or raw == "RGBA" and not extra):
        planar = 1  # Pillow reads these chunky only (test_left_out_kinds_raise_naming_them)
    if compression == 1 and raw in tiff._NO_RAW_UNPACKER:
        compression = 5  # Pillow's own reader has no unpacker for them
    kw = dict(compression=compression, order="<" if order == tiff.II else ">", extra=extra,
              fill_order=fill, big=i % 4 == 3 and order == tiff.II,
              sample_format=fmt[0] if fmt != (1,) else 0,
              predictor=2 if compression in (5, 8, 32946) and b in (8, 16) and i % 2 else 1,
              planar=planar, tile=(16, 16) if layout == 1 else None, rows_per_strip=5)
    if photometric == 3:
        kw["colormap"] = make_inputs.wide(rng.randint(0, 256, 3 << b))
    return make_inputs.write_tiff(samples, b, photometric, **kw)


@pytest.mark.parametrize("i", range(len(KEYS)))
def test_every_key_gives_pillows_pixels_and_mode(tmp_path, i):
    data = _tiff_of(KEYS[i], i)
    want, mode = _pillow(data)
    parsed = tiff.parse(data)
    assert parsed.mode == mode == tiff.OPEN_INFO[KEYS[i]][0]
    path = str(tmp_path / "x.tif")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(read_pixels(path), want)
    if mode in ("L", "RGB", "RGBA"):
        got, jax = read_image(path), j_read_image(path)
        assert got[1:] == jax[1:] == (H, W)
        np.testing.assert_array_equal(got[0], jax[0])
    else:
        with pytest.raises(UnsupportedImageError,
                           match=f"a {re.escape(KINDS[mode])} TIFF \\(Pillow's mode "
                                 f"{re.escape(mode)}\\)"):
            read_image(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientations_are_undone_as_pillow_does(orientation):
    rgb = np.random.RandomState(orientation).randint(0, 256, (H, W, 3))
    data = make_inputs.write_tiff(rgb, 8, 2, compression=5, orientation=orientation)
    want, _ = _pillow(data)
    np.testing.assert_array_equal(tiff.decode_native(data), want)


def _pillow_writes(mode: str, **kwargs) -> bytes:
    rng = np.random.RandomState(3)
    rgb = Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
    im = {"1": rgb.convert("1"), "F": rgb.convert("F"), "I": rgb.convert("I")}.get(mode, rgb)
    buf = io.BytesIO()
    im.save(buf, format="TIFF", **kwargs)
    return buf.getvalue()


def test_left_out_kinds_raise_naming_them(tmp_path):
    field = b"\x03\x01\x03\x00\x01\x00\x00\x00"  # Compression, SHORT, 1 value
    group4 = _pillow_writes("1", compression="group4")
    named = {
        "old-style JPEG TIFFs": group4.replace(field + b"\x04\x00", field + b"\x06\x00"),
        "ThunderScan TIFFs": group4.replace(field + b"\x04\x00", field + b"\x29\x80"),
        "planar TIFFs of 16-bit samples": make_inputs.write_tiff(
            np.zeros((4, 4, 3), np.int64), 16, 2, planar=2, compression=5),
        "compressed planar RGBA TIFFs without ExtraSamples": make_inputs.write_tiff(
            np.zeros((4, 4, 4), np.int64), 8, 2, planar=2, compression=5),
    }
    for match, data in named.items():
        if "JPEG" not in match and "ThunderScan" not in match:
            _pillow(data)  # Pillow reads each (not its libtiff's codecs of recoded fax data)
        with pytest.raises(UnsupportedImageError, match=re.escape(match)):
            tiff.decode_native(data)
    unknown = make_inputs.write_tiff(np.zeros((4, 4, 2), np.int64), 8, 2)
    with pytest.raises(OSError):
        _pillow(unknown)
    with pytest.raises(ValueError, match="not a pixel layout Pillow reads") as e:
        tiff.decode_native(unknown)
    assert not isinstance(e.value, UnsupportedImageError)


def _damaged(rng, data: bytes) -> bytes:
    """``data`` cut short, or with a few bytes set to random values."""
    if rng.rand() < 0.3:
        return data[:rng.randint(8, len(data))]
    out = bytearray(data)
    for at in rng.randint(0, len(data), rng.randint(1, 4)):
        out[at] = rng.randint(256)
    return bytes(out)


@pytest.mark.parametrize("compression", [1, 5, 32773, 8])
def test_damaged_files_raise_where_pillow_raises(compression):
    rng = np.random.RandomState(compression)
    rgb = make_inputs.smooth(24, 40, seed=compression, noise=0.3)
    files = [make_inputs.write_tiff(rgb, 8, 2, compression=compression, rows_per_strip=6,
                                    predictor=2 if compression in (5, 8) else 1),
             make_inputs.write_tiff(rgb[..., :1] % 16, 4, 1, compression=compression,
                                    tile=(16, 16))]
    for n in range(120):
        data = _damaged(rng, files[n % 2])
        try:
            want = _pillow(data)[0]
        except Exception:  # noqa: BLE001 (Pillow raises many kinds)
            with pytest.raises(ValueError):
                tiff.decode_native(data)
            continue
        try:
            got = tiff.decode_native(data)
        except ValueError:
            continue  # stricter than Pillow: allowed
        np.testing.assert_array_equal(got, want)
