"""The port's evaluation CLIs (``cli/test.py``, ``cli/random_noise.py``
with ``-degrade``, ``cli/recompression.py``) and their analysis functions
against the JAX package's on the CPU: the same 64x64 PNGs, hyper q1 demo
weights, one torch thread.

Bounds, each with its reason:
* single forwards (``test``, with and without the self-ensemble, the noise
  evaluation with the same numpy noise on both sides, ``deblur``): bpp
  rtol 1e-4 (the bound of ``tests/torch_parity.py``), PSNR, its
  difference ``dpsnr`` and ``vi_noise`` within 1e-3 dB, MS-SSIM within
  1e-5 (float32 sums in another order).
* ``calibrated_blur``: the same sigma (the same float64 decrements and the
  same comparisons against the budget) and the blurred image within 1e-6.
* recompression: each cycle rounds to 8 bits, so a float32 difference of
  ~1e-7 flips a pixel that sits at a rounding boundary by one level, and
  the next cycle carries the flip on.  Short chains (3 cycles) are held at
  the single-forward bounds above, long ones (20 cycles) against a float64
  witness, the port run with its model in float64: both float32 runs'
  bpp within 1e-3 relative and PSNR within 0.01 dB of it (measured at
  most 6e-7 relative and 2e-6 dB: at 64x64 no level flipped).
* the ``-q 0`` sweeps: the same sequence of (noise, quality) runs and
  headers as the JAX CLIs'.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.analysis import random_noise as j_rn
from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu_torch.analysis import random_noise as rn
from imagecompression_adversarial_tpu_torch.analysis import make_recompression_fn
from imagecompression_adversarial_tpu_torch.config import Config, parse_config
from imagecompression_adversarial_tpu_torch.io.image import read_image, write_image
from imagecompression_adversarial_tpu_torch.models import GDN
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, CKPT, image, nchw, nhwc, one_torch_thread,
)

FLAGS = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cpu"]
J_EXTRA = ["-compile_cache", "none"]
DB_ATOL = 1e-3
MSIM_ATOL = 1e-5
BLUR_ATOL = 1e-6
WITNESS_BPP_RTOL = 1e-3
WITNESS_PSNR_DB = 1e-2


def _cli(name):
    return (importlib.import_module(f"imagecompression_adversarial_tpu.cli.{name}"),
            importlib.import_module(f"imagecompression_adversarial_tpu_torch.cli.{name}"))


def _corpus(tmp_path, seeds=(70, 71)):
    for i, seed in enumerate(seeds):
        write_image(image(seed), str(tmp_path / f"kodim{i + 1:02d}.png"))
    return str(tmp_path / "kodim*.png")


def _same(got, ref, fields):
    for k in fields:
        if k.startswith("bpp"):
            np.testing.assert_allclose(got[k], ref[k], rtol=BPP_RTOL, err_msg=k)
        elif k == "msim":
            assert abs(got[k] - ref[k]) <= MSIM_ATOL, (k, got[k], ref[k])
        else:
            assert abs(got[k] - ref[k]) <= DB_ATOL, (k, got[k], ref[k])


@pytest.mark.parametrize("defend", [False, True])
def test_test_cli_matches_jax(tmp_path, capsys, defend):
    j_cli, cli = _cli("test")
    argv = FLAGS + ["-s", _corpus(tmp_path)] + (["--defend"] if defend else [])
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    capsys.readouterr()
    got = cli.run(parse_config(argv))
    _same(got, ref, ("bpp", "psnr", "msim", "msim_dB"))
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["kodim01.png", "kodim02.png", "AVG"]


def test_random_noise_cli_matches_jax_on_the_same_noise(tmp_path, monkeypatch):
    """Both CLIs get the same numpy noise, by image shape (the JAX CLI's
    jitted function traces once a shape, so its key cannot pick it)."""
    j_cli, cli = _cli("random_noise")
    write_image(image(74), str(tmp_path / "kodim01.png"))
    write_image(image(75, 64, 128), str(tmp_path / "kodim02.png"))
    noises = {(64, w): np.random.RandomState(w).randn(1, 64, w, 3).astype(np.float32)
              for w in (64, 128)}
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(noises[shape[1:3]], dtype))
    seeds = []

    def port_noise(x, generator):
        seeds.append(generator.initial_seed())
        return nchw(noises[tuple(x.shape[2:])]).to(x)

    monkeypatch.setattr(rn, "gaussian_noise", port_noise)
    argv = FLAGS + ["-s", str(tmp_path / "kodim*.png"), "-noise", "1e-3"]
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    got = cli.run(parse_config(argv))
    assert seeds == [0, 1]  # image i's generator is seeded with i
    _same(got, ref, ("vi_noise", "bpp", "bpp_ori", "psnr"))


def test_calibrated_blur_matches_jax():
    x = image(72)  # uniform noise: the 5x5 blur's MSE is ~0.079 at sigma 5
    want, j_sigma = j_rn.calibrated_blur(x, target_mse=0.078)
    got, sigma = rn.calibrated_blur(nchw(x), target_mse=0.078)
    assert sigma == j_sigma and 3.0 < sigma < 4.9  # the loop annealed
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=BLUR_ATOL)
    np.testing.assert_allclose(nhwc(rn.gaussian_blur(nchw(x), 1.3)),
                               np.asarray(j_rn.gaussian_blur(jnp.asarray(x), 1.3)),
                               atol=BLUR_ATOL)


def test_blurgen_and_deblur_match_jax(tmp_path, monkeypatch, capsys):
    j_cli, cli = _cli("random_noise")
    src = _corpus(tmp_path)
    blurred = {}
    for side, mod, parse in (("jax", j_cli, j_parse_config), ("port", cli, parse_config)):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        extra = J_EXTRA if side == "jax" else []
        assert mod.run(parse(["-s", src, "-noise", "2e-4", "-degrade", "blurgen",
                              "-device", "cpu"] + extra)) == {}
        blurred[side] = [read_image(str(tmp_path / side / "attack" / "blur" / f"kodim0{i}.png"))[0]
                         for i in (1, 2)]
    for a, b in zip(blurred["port"], blurred["jax"]):
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-7  # one 8-bit level at most
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "sigma" in ln]
    assert len(lines) == 4 and lines[:2] == lines[2:]  # the same sigmas printed
    argv = FLAGS + ["-s", str(tmp_path / "port" / "attack" / "blur" / "*.png"), "-t", src,
                    "-degrade", "deblur"]
    _same(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)),
          ("dpsnr", "bpp", "psnr_out"))


@pytest.mark.parametrize("defend", [False, True])
def test_recompression_cli_matches_jax(tmp_path, defend):
    j_cli, cli = _cli("recompression")
    argv = FLAGS + ["-s", _corpus(tmp_path), "-re", "3"] + (["--defend"] if defend else [])
    _same(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)),
          ("bpp", "psnr", "msim", "msim_dB"))


def test_long_recompression_against_a_float64_witness():
    from imagecompression_adversarial_tpu.analysis import make_recompression_fn as j_make
    from torch_parity import hyper_models

    jm, jp, model = hyper_models()
    x = image(73)
    j_res = j_make(jm, repeats=20)(jp, jnp.asarray(x))
    res = make_recompression_fn(model, repeats=20)(nchw(x))
    model64 = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT)).double()
    for m in model64.modules():
        if isinstance(m, GDN):
            m.use_kernel = False  # the plain GDN, which sums in float64
    witness = make_recompression_fn(model64, repeats=20)(nchw(x).double())
    for got in (res, {k: torch.as_tensor(np.asarray(v)) for k, v in j_res.items()}):
        np.testing.assert_allclose(float(got["bpp"]), float(witness["bpp"]),
                                   rtol=WITNESS_BPP_RTOL)
        assert abs(float(got["psnr"]) - float(witness["psnr"])) <= WITNESS_PSNR_DB
    assert res["bpp_trajectory"].shape == (20,)


@pytest.mark.parametrize("name", ["test", "random_noise"])
def test_quality_sweeps_match_jax(monkeypatch, capsys, name):
    j_cli, cli = _cli(name)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(j_cli, "run", lambda cfg: seen["jax"].append((cfg.noise, cfg.quality)))
    monkeypatch.setattr(cli, "run", lambda cfg: seen["port"].append((cfg.noise, cfg.quality)))
    argv = ["-m", "hyper", "-q", "0", "-device", "cpu"]
    j_cli.main(argv)
    want = capsys.readouterr().out
    cli.main(argv)
    assert capsys.readouterr().out == want
    assert seen["port"] == seen["jax"]
    assert len(seen["port"]) == (8 if name == "test" else 32)


def chain_gaps(cycles: int = 50) -> dict:
    """How far the port's float32 runs (oneDNN on and off) sit from its
    float64 run of the recompression chain, on the two 768x512 images of
    ``chip_smoke.py`` phase 16: the largest gap of each value over both
    images, bpp relative (the basis of that phase's "chain" bounds)."""
    from imagecompression_adversarial_tpu_torch.io.image import synthetic_image, to_tensor

    images = [to_tensor(np.round(synthetic_image(512, 768, seed=10 + i) * 255) / 255, "cpu")
              for i in (1, 2)]  # as the PNGs of that phase read back
    runs = {}
    for name, dtype, mkldnn in (("f32", torch.float32, True), ("f32 no oneDNN", torch.float32,
                                                              False), ("f64", torch.float64, True)):
        model = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
        model = model.to(dtype)
        for m in model.modules():
            if isinstance(m, GDN):
                m.use_kernel = dtype == torch.float32
        fn = make_recompression_fn(model, repeats=cycles)
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            runs[name] = [{k: float(v) for k, v in fn(x.to(dtype)).items() if k != "bpp_trajectory"}
                          for x in images]
    gaps = {}
    for name in ("f32", "f32 no oneDNN"):
        for got, ref in zip(runs[name], runs["f64"]):
            for k, v in got.items():
                gap = abs(v - ref[k]) / (abs(ref[k]) if k == "bpp" else 1.0)
                gaps[k] = max(gaps.get(k, 0.0), gap)
    return gaps


if __name__ == "__main__":
    print(chain_gaps())
