"""The port's numpy baseline JPEG coder (``io/jpeg.py``) and its
``cli/jpeg_baseline.py`` against Pillow (libjpeg-turbo), where Pillow is
installed (the GPU machine has none), and against the JAX CLI, which codes
through Pillow.

Measured, and held as measured: the bytes ``io.jpeg.encode`` writes equal
Pillow's ``save(format="JPEG", quality=q)`` byte for byte (so the byte
counts are equal), at q 10, 50, 90 and 100, on smooth and noisy images and
on sizes that are not multiples of 8 or 16; ``io.jpeg.decode`` of Pillow's
bytes equals Pillow's decode pixel for pixel (tighter than the one level
first set as its bound).  ``jpeg_baseline``'s AVG bpp within 0.5% and PSNR
within 0.05 dB of the JAX CLI's (the bounds set for the CLI; with equal
bytes and pixels they agree to the printed digit).
"""

import importlib
import io

import numpy as np
import pytest

from imagecompression_adversarial_tpu_torch.io import jpeg
from imagecompression_adversarial_tpu_torch.io.image import write_image

BPP_RTOL = 5e-3
PSNR_ATOL_DB = 0.05


def _image(h, w, seed, noisy=False):
    rng = np.random.RandomState(seed)
    if noisy:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + seed), 128 + 90 * np.cos(yy / 5.0),
                    128 + 60 * np.sin((xx + yy) / 9.0)], -1) + rng.rand(h, w, 3) * 40
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(rgb, quality, **kwargs):
    image_mod = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    image_mod.fromarray(rgb).save(buf, format="JPEG", quality=quality, **kwargs)
    data = buf.getvalue()
    return data, np.asarray(image_mod.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("quality", [50, 90, 10, 100])
@pytest.mark.parametrize("h, w, noisy", [(64, 64, False), (37, 53, False), (48, 80, True),
                                         (9, 3, False), (512, 768, False)])
def test_encode_equals_pillow_bytes_and_decode_its_pixels(quality, h, w, noisy):
    rgb = _image(h, w, seed=h + w + quality, noisy=noisy)
    want, want_px = _pillow(rgb, quality)
    got = jpeg.encode(rgb, quality)
    assert len(got) == len(want)
    assert got == want
    np.testing.assert_array_equal(jpeg.decode(want), want_px)


def test_decode_rejects_what_it_does_not_read():
    """A hierarchical frame (SOF5) is refused, as Pillow refuses it (a
    lossless one, refused up to slice 19, is read since); a progressive
    file, refused up to slice 15, decodes to Pillow's pixels."""
    rgb = _image(32, 32, seed=1)
    progressive, want = _pillow(rgb, 75, progressive=True)
    np.testing.assert_array_equal(jpeg.decode(progressive), want)
    baseline, _ = _pillow(rgb, 75)
    sof = baseline.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="hierarchical sequential JPEGs are not supported"):
        jpeg.decode(baseline[:sof + 1] + b"\xc5" + baseline[sof + 2:])
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode(b"\x89PNG")
    with pytest.raises(ValueError):
        jpeg.encode(rgb.astype(np.float32), 75)


def test_quant_tables_follow_ijg_scaling():
    luma, chroma = jpeg.quant_tables(50)
    assert luma[0] == 16 and chroma[0] == 17  # Annex K at q 50
    assert jpeg.quant_tables(100)[0].max() == 1 and jpeg.quant_tables(1)[0].max() == 255


def test_jpeg_baseline_cli_matches_jax(tmp_path, capsys):
    pytest.importorskip("PIL")
    for i, seed in enumerate((3, 4)):
        write_image(_image(64, 96, seed)[None].astype(np.float32) / 255.0,
                    str(tmp_path / f"kodim0{i + 1}.png"))
    j_cli = importlib.import_module("imagecompression_adversarial_tpu.cli.jpeg_baseline")
    cli = importlib.import_module("imagecompression_adversarial_tpu_torch.cli.jpeg_baseline")
    argv = [str(tmp_path / "kodim*.png"), "-q", "50", "-device", "cpu"]
    j_cli.main(argv)
    want = capsys.readouterr().out.splitlines()
    got = cli.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(want) == 3
    j_avg = dict(zip(want[-1].split()[1::2], map(float, want[-1].split()[2::2])))
    assert abs(got["bpp"] - j_avg["bpp"]) <= BPP_RTOL * j_avg["bpp"]
    assert abs(got["psnr"] - j_avg["psnr"]) <= PSNR_ATOL_DB
    assert lines == want  # equal bytes and pixels: the same printed digits
