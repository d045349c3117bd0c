"""The port's Netpbm reader (``io/netpbm.py``, numpy) against Pillow 12.1.0
and the JAX package on the CPU, on files made here from seeds with
``make_inputs.write_pnm`` and ``write_pfm``:

* P1-P6, plain and raw, at maxvals from 1 to 65535, with comments in the
  header and the body, rows of odd widths: the pixels of Pillow's
  ``convert("RGB")`` and its mode (``1``, ``L``, ``I``, ``RGB``), bit for
  bit, by ``netpbm.decode`` and ``read_pixels``; gray PFM (``Pf``) both
  ways round as ``F``;
* ``read_image`` equal to JAX's where Pillow's mode is ``L`` or ``RGB``,
  and naming the mode where JAX would take booleans or raw values;
* what Pillow refuses (PAM, colour PFM) raises ``RefusedByPillowError``
  (an ``UnsupportedImageError``) naming the kind, and broken files (short,
  a plain value past maxval, a token too long, maxval 0) raise
  ``ValueError`` where Pillow raises.
"""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.io.image import read_image as j_read_image
from imagecompression_adversarial_tpu_torch.io import netpbm
from imagecompression_adversarial_tpu_torch.io.errors import (RefusedByPillowError,
                                                              UnsupportedImageError)
from imagecompression_adversarial_tpu_torch.io.image import read_image, read_pixels

INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "inputs")
_spec = importlib.util.spec_from_file_location("make_inputs", os.path.join(INPUTS, "make_inputs.py"))
make_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_inputs)

H, W = 23, 37
MAXVALS = [1, 15, 100, 255, 256, 1000, 4095, 65535]


def _samples(maxval: int, channels: int, seed: int) -> np.ndarray:
    s = make_inputs.smooth(H, W, seed=seed, channels=channels, levels=maxval + 1, noise=0.2)
    return s[..., 0] if channels == 1 else s


def _kinds():
    kinds = {}
    for magic, channels in ((b"P2", 1), (b"P5", 1), (b"P3", 3), (b"P6", 3)):
        for i, maxval in enumerate(MAXVALS):
            kinds[f"{magic.decode()}-{maxval}"] = make_inputs.write_pnm(
                _samples(maxval, channels, seed=i), magic, maxval, comments=i % 2 == 0)
    bits = make_inputs.bilevel(H, W, seed=3) // 255
    kinds["P1"] = make_inputs.write_pnm(bits, b"P1", comments=True)
    kinds["P1-packed"] = b"P1\n# no spaces\n4 3\n0110\n10#c\n01 1\n1 0 0 1\n"
    kinds["P4"] = make_inputs.write_pnm(bits, b"P4")
    kinds["P4-w8"] = make_inputs.write_pnm(bits[:, :8], b"P4", comments=True)
    floats = _samples(4095, 1, seed=9).astype(np.float32) / 7.0 - 100.0
    kinds["Pf-le"] = make_inputs.write_pfm(floats, -1.0)
    kinds["Pf-be"] = make_inputs.write_pfm(floats, 2.5)
    # raw samples past maxval are clipped; a comment inside a header token
    kinds["P5-past-maxval"] = b"P5\n3 1\n10\n\x05\x0b\xff"
    kinds["P6-16-past-maxval"] = b"P6\n1 1\n1000\n\x03\xe8\x00\x04\x01\xf4"
    kinds["P2-comment-in-token"] = b"P2\n2#a\n 1\n255\n1#x\n2 3\n"
    return kinds


KINDS = _kinds()


def _pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return im.mode, np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_netpbm_kinds_give_pillows_pixels_and_mode(kind, tmp_path):
    data = KINDS[kind]
    mode, want = _pillow(data)
    got, got_mode = netpbm.decode(data)
    assert got_mode == mode
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "x.pnm"
    path.write_bytes(data)
    np.testing.assert_array_equal(read_pixels(str(path)), want)
    if mode in ("L", "RGB"):
        ours, jax = read_image(str(path), padding=64), j_read_image(str(path), padding=64)
        assert ours[1:] == tuple(jax[1:])
        np.testing.assert_array_equal(ours[0], np.asarray(jax[0]))
    else:
        with pytest.raises(UnsupportedImageError, match=f"Pillow's mode {mode}"):
            read_image(str(path))


def test_modes_follow_maxval():
    """Gray is ``L`` to maxval 255 and ``I`` past it; colour is ``RGB`` at
    every maxval, rescaled as Pillow rescales (1000 of 1000 -> 255, 4 of
    1000 -> 1)."""
    for maxval in MAXVALS:
        assert netpbm.parse(KINDS[f"P5-{maxval}"]).mode == ("L" if maxval < 256 else "I")
        assert netpbm.parse(KINDS[f"P6-{maxval}"]).mode == "RGB"
    assert netpbm.decode(KINDS["P6-16-past-maxval"])[0].tolist() == [[[255, 1, 128]]]


REFUSED = {
    "P7": (b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n" + bytes(6),
           "PAM"),
    "PF": (b"PF\n2 1\n-1.0\n" + bytes(24), "colour PFM"),
}


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_it(kind):
    data, name = REFUSED[kind]
    with pytest.raises(OSError):
        _pillow(data)
    with pytest.raises(RefusedByPillowError, match=name):
        netpbm.decode(data)


BROKEN = {
    "short": (b"P6\n2 2\n255\n" + bytes(5), "not enough image data"),
    "past-maxval": (b"P2\n2 1\n10\n5 11\n", "too large"),
    "negative": (b"P2\n2 1\n10\n-5 1\n", "negative"),
    "maxval-0": (b"P5\n2 1\n0\n\x00\x00", "maxval must be greater than 0"),
    "maxval-65536": (b"P5\n2 1\n65536\n" + bytes(4), "maxval must be greater than 0"),
    "bad-bit": (b"P1\n2 1\n0 2\n", "invalid token"),
    "long-token": (b"P2\n2 1\n255\n00000000001 2\n", "token too long"),
    "long-header-token": (b"P5\n00000000002 1\n255\n\x01\x02", "header token too long"),
}


@pytest.mark.parametrize("kind", sorted(BROKEN))
def test_broken_files_raise_value_error_where_pillow_raises(kind):
    data, match = BROKEN[kind]
    with pytest.raises((OSError, ValueError)):
        _pillow(data)
    with pytest.raises(ValueError, match=match):
        netpbm.decode(data)
