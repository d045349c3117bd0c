"""The port's analysis CLIs (``feature_range``, ``search``,
``attack_linear``, ``transfer_noise``, ``visual``, ``visual_distribution``,
``compare``, ``mmd``) against the JAX CLIs with ``-device cpu``: two 64x64
PNGs, hyper q1 demo weights, one torch thread; each package runs in a
working directory of its own and their printed numbers and files are
compared.  (``jpeg_baseline`` is held in ``tests/test_torch_jpeg.py``.)

Bounds, each with its reason:
* forward-only numbers (the profile, ``visual``'s PSNR, the rates behind
  ``visual_distribution``'s ranking, ``compare``): the bounds of
  ``tests/test_torch_analysis.py`` and ``tests/test_torch_metrics_extra.py``
  (PROFILE_ATOL 1e-5; PSNR 1e-3 dB; MS-SSIM 1e-6).  The search scores
  within SCORE_RTOL = 1e-4 relative: here each side scores against its own
  profile, and the score divides an overshoot by ``channel_max + 1``, which
  is small for some channels, so the profiles' and latents' 1e-5 gaps grow
  (measured 2.5e-5 relative on a score of 11.05).  ``y_hat`` equal (the
  same integers); reconstructions
  within one 8-bit level; the printed inflation, rounded to 0.1 bit,
  within 0.1 of JAX's, and the channel ranking the same up to ties (as in
  ``tests/test_torch_analysis.py``).
* the attacks of ``attack_linear`` and ``transfer_noise`` (6 steps, oneDNN
  off): vi and the cross-image matrix within VI_ATOL
  (``tests/torch_parity.py``); the port's cross-model matrix of hyper
  against itself (lazy legs, the JAX side's is held in
  ``tests/test_torch_analysis.py``) within VI_ATOL of the mean of its
  cross-image diagonal, which it computes again.
* ``mmd``: the port's random-conv kernels replaced by JAX's (the two
  packages draw them from different generators): features within 1e-5
  relative, so FID, KID and IS within MMD_RTOL = 1e-4 relative (FID on 12
  samples of 8 features; one feature is dead after the ReLU, so scipy's
  sqrtm warns of a singular product on both sides); ``--model alex``
  with the same lpips state dict: the feature codes within 1e-5 relative
  and IS within MMD_RTOL.
* ``visual -degrade noise`` and ``mmd --model random`` draw from a
  ``torch.Generator`` in the port and from ``jax.random`` in JAX: the tests
  hand both the same arrays.
"""

import importlib
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagecompression_adversarial_tpu.analysis as j_analysis
from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu_torch.config import parse_config
from imagecompression_adversarial_tpu_torch.defenses import load_range_profile
from imagecompression_adversarial_tpu_torch.io.image import read_image, write_image
from imagecompression_adversarial_tpu_torch.metrics import fid
from test_torch_analysis import assert_same_ranking
from test_torch_metrics_extra import jax_conv_kernels
from torch_parity import CKPT, VI_ATOL, hyper_models, image, one_torch_thread, onednn  # noqa: F401

FLAGS = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cpu"]
J_EXTRA = ["-compile_cache", "none"]
PROFILE_ATOL = 1e-5
SCORE_RTOL = 1e-4
DB_ATOL = 1e-3
MSIM_ATOL = 1e-6
MMD_RTOL = 1e-4
CODES_RTOL = 1e-5
STEPS = ["-steps", "6"]
PROFILE = os.path.join("attack", "data", "hyper-mse-1_range.npz")


def _cli(name):
    return (importlib.import_module(f"imagecompression_adversarial_tpu.cli.{name}"),
            importlib.import_module(f"imagecompression_adversarial_tpu_torch.cli.{name}"))


def _corpus(tmp_path, seeds=(60, 61), name="kodim", scale=1.0):
    os.makedirs(tmp_path / "data", exist_ok=True)
    for i, seed in enumerate(seeds):
        write_image(np.clip(image(seed) * scale, 0, 1),
                    str(tmp_path / "data" / f"{name}{i + 1:02d}.png"))
    return str(tmp_path / "data" / f"{name}*.png")


def _sides(tmp_path, monkeypatch):
    """Run ``fn(side)`` in ``tmp_path/side`` for side jax, then port."""
    def each(fn):
        out = {}
        for side in ("jax", "port"):
            os.makedirs(tmp_path / side, exist_ok=True)
            monkeypatch.chdir(tmp_path / side)
            out[side] = fn(side)
        return out
    return each


def _no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)


def test_feature_range_and_search_clis_match_jax(tmp_path, monkeypatch, capsys):
    src = _corpus(tmp_path)
    odd = _corpus(tmp_path, seeds=(62, 60), name="odd", scale=1.6)  # off the profile
    j_fr, fr = _cli("feature_range")
    j_se, se = _cli("search")

    def run(side):
        if side == "jax":
            j_fr.run(j_parse_config(FLAGS + ["-s", src] + J_EXTRA))
            out = capsys.readouterr().out
            found = j_se.run(j_parse_config(FLAGS + ["-s", odd] + J_EXTRA))
        else:
            fr.run(parse_config(FLAGS + ["-s", src]))
            out = capsys.readouterr().out
            found = se.run(parse_config(FLAGS + ["-s", odd]))
        return out, found, capsys.readouterr().out, sorted(os.listdir("attack/search"))

    res = _sides(tmp_path, monkeypatch)(run)
    (j_out, j_found, j_search, j_files), (out, found, search, files) = res["jax"], res["port"]
    assert out.splitlines()[0] == j_out.splitlines()[0]
    assert "saved profile -> ./attack/data/hyper-mse-1_range.npz" in out
    want, got = (np.load(tmp_path / side / PROFILE) for side in ("jax", "port"))
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        if key in ("ranks_max", "ranks_min", "dead"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=PROFILE_ATOL, err_msg=key)
    load_range_profile(str(tmp_path / "jax" / PROFILE), require=("dead", "ranks_min"))
    assert [os.path.basename(f) for f, _ in found] == [os.path.basename(f) for f, _ in j_found]
    for (_, a), (_, b) in zip(found, j_found):
        assert abs(a - b) <= SCORE_RTOL * abs(b), (a, b)
    assert search.count("FOUND YOU!") == j_search.count("FOUND YOU!") >= 1
    assert len(files) == len(j_files) and [f[:5] for f in files] == [f[:5] for f in j_files]


def test_search_quality_sweep_matches_jax(monkeypatch):
    j_cli, cli = _cli("search")
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(j_cli, "run", lambda cfg: seen["jax"].append(cfg.quality))
    monkeypatch.setattr(cli, "run", lambda cfg: seen["port"].append(cfg.quality))
    j_cli.main(["-m", "cheng2020", "-q", "0", "-device", "cpu"])
    cli.main(["-m", "cheng2020", "-q", "0", "-device", "cpu"])
    assert seen["port"] == seen["jax"] == [1, 2, 3, 4, 5, 6]


def test_attack_linear_cli_matches_jax(tmp_path, monkeypatch, capsys):
    src = _corpus(tmp_path)
    j_fr, fr = _cli("feature_range")
    j_al, al = _cli("attack_linear")

    def run(side):
        if side == "jax":
            j_fr.run(j_parse_config(FLAGS + ["-s", src] + J_EXTRA))
            capsys.readouterr()
            return j_al.run(j_parse_config(FLAGS + STEPS + ["-s", src] + J_EXTRA))
        fr.run(parse_config(FLAGS + ["-s", src]))
        capsys.readouterr()
        with onednn(False):
            return al.run(parse_config(FLAGS + STEPS + ["-s", src]))

    res = _sides(tmp_path, monkeypatch)(run)
    assert sorted(res["port"]) == sorted(res["jax"]) == ["kodim01", "kodim02"]
    for stem, want in res["jax"].items():
        got = res["port"][stem]
        assert abs(got["vi"] - want["vi"]) <= VI_ATOL and got["exceeded"] == want["exceeded"]
        for side in ("jax", "port"):
            assert (tmp_path / side / f"hyper_1_{stem}_activations.png").is_file()
        data = np.load(tmp_path / "port" / f"hyper_1_{stem}_activations.npz")
        assert data["adversarial"].shape == data["natural"].shape == (192,)
    # without matplotlib: the numbers, and one line for the plot not written
    _no_matplotlib(monkeypatch)
    os.remove(tmp_path / "port" / "hyper_1_kodim01_activations.png")
    capsys.readouterr()
    with onednn(False):
        again = al.run(parse_config(FLAGS + ["-steps", "2", "-s", src.replace("*", "01")]))
    out = capsys.readouterr().out
    assert "plot not written: hyper_1_kodim01_activations.png (matplotlib is not installed)" in out
    assert np.isfinite(again["kodim01"]["vi"])
    assert not (tmp_path / "port" / "hyper_1_kodim01_activations.png").exists()


def test_transfer_noise_clis_match_jax(tmp_path, monkeypatch, capsys):
    src = _corpus(tmp_path)
    j_tn, tn = _cli("transfer_noise")
    cross = ["--cross-model", "-cross", f"hyper:1:{CKPT},hyper:1:{CKPT}"]

    def run(side):
        argv = FLAGS + STEPS + ["-s", src]
        if side == "jax":
            return j_tn.run(j_parse_config(argv + J_EXTRA)), None
        with onednn(False):
            return tn.main(argv), tn.main(STEPS + ["-s", src, "-device", "cpu"] + cross)

    res = _sides(tmp_path, monkeypatch)(run)
    got, want = res["port"][0], res["jax"][0]
    assert got.shape == want.shape == (2, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=VI_ATOL)
    # the same model in both legs: every cell is the mean of an image's own
    # noise pasted back onto it, the cross-image matrix's diagonal
    assert res["port"][1].shape == (2, 2)
    np.testing.assert_allclose(res["port"][1], np.full((2, 2), np.diag(got).mean()), rtol=0,
                               atol=VI_ATOL)
    for name in ("hyper_1_mse_transfer.npy", "transfer_cross_model.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      res["port"][0 if name.startswith("hyper") else 1])
    for name in ("hyper_1_mse_transfer.pdf", "transfer_cross_model.pdf"):
        assert (tmp_path / "port" / name).is_file()
    assert (tmp_path / "jax" / "hyper_1_mse_transfer.pdf").is_file()
    out = capsys.readouterr().out
    assert "models: hyper-q1 hyper-q1" in out and "[attack 2/2] image 2/2 done" in out
    # without matplotlib, and -s2 naming the images
    _no_matplotlib(monkeypatch)
    with onednn(False):
        tn.main(FLAGS + ["-steps", "2", "-s", "unused", "-s2", src.replace("*", "01")])
    assert "plot not written: hyper_1_mse_transfer.pdf" in capsys.readouterr().out
    assert np.load(tmp_path / "port" / "hyper_1_mse_transfer.npy").shape == (1, 1)


@pytest.mark.parametrize("noised", [False, True])
def test_visual_cli_matches_jax(tmp_path, monkeypatch, capsys, noised):
    src = _corpus(tmp_path, seeds=(63,)).replace("*", "01")
    j_vi, vi = _cli("visual")
    extra = ["-degrade", "noise"] if noised else []
    noise = np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(noise))
    monkeypatch.setattr(vi, "degrade_noise", lambda im: np.clip(
        im + vi.NOISE_SIGMA * noise, 0.0, 1.0).astype(np.float32))

    def run(side):
        argv = FLAGS + ["-s", src, "-t", "out.png"] + extra
        if side == "jax":
            j_vi.main(argv + J_EXTRA)
        else:
            vi.main(argv)
        return float(capsys.readouterr().out.split("psnr")[-1])

    res = _sides(tmp_path, monkeypatch)(run)
    assert abs(res["port"] - res["jax"]) <= 0.01 + DB_ATOL  # printed to 2 decimals
    got = vi.run(parse_config(FLAGS + ["-s", src, "-t", "out.png"]), noised=noised)
    capsys.readouterr()
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "out_y_hat.npy"),
                                  np.load(tmp_path / "jax" / "out_y_hat.npy"))
    for name in ["out.png"] + (["out_in.png"] if noised else []):
        a, b = (read_image(str(tmp_path / side / name))[0] for side in ("port", "jax"))
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-7, name
    assert abs(got["psnr"] - float(j_vi.run(j_parse_config(
        FLAGS + ["-s", src, "-t", "out.png"] + J_EXTRA), noised=noised)["psnr"])) <= DB_ATOL


@pytest.mark.parametrize("with_target", [True, False])
def test_visual_distribution_cli_matches_jax(tmp_path, monkeypatch, capsys, with_target):
    src = _corpus(tmp_path, seeds=(64,)).replace("*", "01")
    adv = _corpus(tmp_path, seeds=(65,), name="adv", scale=1.3).replace("*", "01")
    j_vd, vd = _cli("visual_distribution")
    argv = FLAGS + ["-s", src] + (["-t", adv] if with_target else [])

    def run(side):
        res = (j_vd.run(j_parse_config(argv + J_EXTRA)) if side == "jax"
               else vd.run(parse_config(argv)))
        return res, capsys.readouterr().out

    res = _sides(tmp_path, monkeypatch)(run)
    (want, j_out), (got, out) = res["jax"], res["port"]
    for side in ("jax", "port"):
        assert (tmp_path / side / "hyper_1_distribution.png").is_file()
    if with_target:
        jm, jp, _ = hyper_models()
        lik = [jm.apply({"params": jp}, jnp.asarray(read_image(f)[0]),
                        quant_mode="dequantize")["likelihoods"]["y"] for f in (src, adv)]
        inflation = j_analysis.rate_inflation_ranking(*lik)["inflation"]
        assert_same_ranking(got["channels_by_rate"], want["channels_by_rate"], inflation)
        infl = [np.array(json.loads(o.splitlines()[1].split(":", 1)[1])) for o in (out, j_out)]
        assert np.abs(infl[0] - infl[1]).max() <= 0.1 + 1e-9
    else:
        assert got["channels_by_rate"] is want["channels_by_rate"] is None
        assert out.splitlines()[0] == j_out.splitlines()[0]  # the highest-rate channel
    data = np.load(tmp_path / "port" / "hyper_1_distribution.npz")
    assert int(data["channel"]) == got["channel"] and data["pmf"].shape == (61,)
    np.testing.assert_allclose(data["pmf"].sum(), 1.0, atol=1e-3)
    # without matplotlib: the numbers, and one line for the plot not written
    _no_matplotlib(monkeypatch)
    os.remove("hyper_1_distribution.npz")
    again = vd.run(parse_config(argv))
    assert "plot not written: hyper_1_distribution.png" in capsys.readouterr().out
    assert "plot" not in again and os.path.isfile("hyper_1_distribution.npz")


def test_compare_cli_matches_jax(tmp_path, capsys):
    a = _corpus(tmp_path, seeds=(66, 67), name="ori")
    b = _corpus(tmp_path, seeds=(66, 67), name="rec", scale=0.97)
    j_cmp, cmp = _cli("compare")
    j_cmp.main([a, b, "-device", "cpu"])
    j_avg = dict(zip(*[iter(capsys.readouterr().out.splitlines()[-1].split()[1:])] * 2))
    got = cmp.main([a, b, "-device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0].startswith("ori01.png vs rec01.png: psnr ")
    assert abs(got["psnr"] - float(j_avg["psnr"])) <= 5e-5 + DB_ATOL  # printed to 4 decimals
    assert abs(got["msim"] - float(j_avg["msim"])) <= 5e-5 + MSIM_ATOL


def test_mmd_cli_random_features_match_jax(tmp_path, monkeypatch):
    """The port's conv kernels replaced by JAX's; 12-image .npy stacks."""
    j_mmd, mmd = _cli("mmd")
    rng = np.random.RandomState(8)
    for name, shift in (("a", 0.0), ("b", 0.1)):
        np.save(tmp_path / f"{name}.npy",
                np.clip(rng.rand(12, 32, 32, 3) + shift, 0, 1).astype(np.float32))
    monkeypatch.setattr(fid, "conv_kernels", jax_conv_kernels)
    argv = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), "--dims", "8", "--do-fid",
            "--do-mmd", "--mmd-subsets", "4", "--mmd-subset-size", "6", "--splits", "3",
            "-device", "cpu"]
    j_mmd.main(argv + ["-o", str(tmp_path / "jax.json")])
    got = mmd.main(argv + ["-o", str(tmp_path / "port.json"), "--save-codes",
                           str(tmp_path / "codes.npy")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert sorted(got) == sorted(want) and got["n_samples"] == got["n_reference"] == 12
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=MMD_RTOL)
    np.testing.assert_allclose(got["kid"], want["kid"], rtol=MMD_RTOL)
    np.testing.assert_allclose(got["is"], want["is"], rtol=MMD_RTOL)
    # the saved codes as input: the same metrics from the 2-D .npy
    again = mmd.main([str(tmp_path / "codes.npy"), str(tmp_path / "b.npy"), "--dims", "8",
                      "--do-fid", "--no-inception", "-device", "cpu"])
    assert again["fid"] == got["fid"] and "is" not in again


def test_mmd_cli_alex_features_match_jax(tmp_path, capsys):
    j_mmd, mmd = _cli("mmd")
    src = _corpus(tmp_path, seeds=(68, 69))
    gen = torch.Generator().manual_seed(9)
    shapes = {"net.slice1.0": (64, 3, 11, 11), "net.slice2.3": (192, 64, 5, 5),
              "net.slice3.6": (384, 192, 3, 3), "net.slice4.8": (256, 384, 3, 3),
              "net.slice5.10": (256, 256, 3, 3)}
    state = {}
    for key, shape in shapes.items():
        fan_in = shape[1] * shape[2] * shape[3]
        state[f"{key}.weight"] = torch.randn(shape, generator=gen) / fan_in ** 0.5
        state[f"{key}.bias"] = 0.01 * torch.randn(shape[0], generator=gen)
    for i, (shape) in enumerate(shapes.values()):
        state[f"lin{i}.model.1.weight"] = torch.rand((1, shape[0], 1, 1), generator=gen)
    state["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    state["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)
    ckpt = str(tmp_path / "alex.pth")
    torch.save(state, ckpt)
    argv = [src, "--model", "alex", "--alex-ckpt", ckpt, "--splits", "2", "-device", "cpu"]
    j_mmd.main(argv + ["--save-codes", str(tmp_path / "jax_codes.npy")])
    want_is = float(re.search(r"IS: (\S+)", capsys.readouterr().out).group(1))
    got = mmd.main(argv + ["--save-codes", str(tmp_path / "codes.npy")])
    codes, j_codes = np.load(tmp_path / "codes.npy"), np.load(tmp_path / "jax_codes.npy")
    assert codes.shape == j_codes.shape == (2, 256)
    np.testing.assert_allclose(codes, j_codes, rtol=CODES_RTOL, atol=1e-7)
    np.testing.assert_allclose(got["is"][0], want_is, rtol=MMD_RTOL, atol=5e-5)  # printed to 4
