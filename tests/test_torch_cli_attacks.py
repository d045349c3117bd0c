"""The port's attack and defense CLIs vs the JAX package's, on the CPU:
the same PNG (64x64; 160x160 for the patch CLI), hyper q1 demo weights and
a few steps on both sides, and the same report values.

The CLIs run on the CPU entry point's default convolution backend (oneDNN
on), so the bounds are those of oneDNN-on runs: vi within 1e-3 dB (1e-2
for the sign-gradient attack, whose steps may flip on near-zero gradients),
bpp rtol 1e-4.  Where the JAX CLI draws noise from ``jax.random`` and the
port from a ``torch.Generator`` (``-random 2``), both are handed the same
arrays.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu_torch.config import parse_config
from imagecompression_adversarial_tpu_torch.io.image import read_image, write_image
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, CKPT, VI_ATOL, image, nchw, one_torch_thread,
)

FLAGS = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cpu"]
J_EXTRA = ["-compile_cache", "none"]
FIELDS = ("bpp_ori", "bpp", "vi", "vi_msim")


def _cli(name):
    return (importlib.import_module(f"imagecompression_adversarial_tpu.cli.{name}"),
            importlib.import_module(f"imagecompression_adversarial_tpu_torch.cli.{name}"))


def _png(tmp_path, seed, h=64, w=64, name="kodim01.png"):
    path = str(tmp_path / name)
    write_image(image(seed, h, w), path)
    return path


def _same_report(got, ref, vi_atol=VI_ATOL, fields=FIELDS):
    for k in fields:
        if k.startswith("vi"):
            assert abs(got[k] - ref[k]) <= vi_atol, (k, got[k], ref[k])
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=BPP_RTOL, err_msg=k)


@pytest.mark.parametrize("args", [
    ["--defend", "--defend_m", "ensemble"],
    ["--defend", "--defend_m", "bitdepth", "--adv"],
    ["--defend", "--defend_m", "resize", "--adv"],
])
def test_self_ensemble_cli_matches_jax(tmp_path, capsys, args):
    j_cli, cli = _cli("self_ensemble")
    argv = FLAGS + ["-s", _png(tmp_path, 50), "-steps", "3"] + args
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    got = cli.run(parse_config(argv))
    _same_report(got, ref)
    lines = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith("kodim01.png: bpp_ori ") for ln in lines) == 2
    assert sum(ln.startswith("AVG: bpp_ori ") for ln in lines) == 2


def test_self_ensemble_cli_clip_with_profile(tmp_path):
    from imagecompression_adversarial_tpu_torch.runtime import load_model
    from imagecompression_adversarial_tpu_torch.config import Config

    j_cli, cli = _cli("self_ensemble")
    src = _png(tmp_path, 51)
    model = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    with torch.no_grad():
        absmax = model.g_a(nchw(read_image(src)[0])).abs().amax(dim=(0, 2, 3)).numpy()
    ranks = np.empty(absmax.size, np.int64)
    ranks[np.argsort(-absmax, kind="stable")] = np.arange(absmax.size)
    prof = str(tmp_path / "prof.npz")
    np.savez(prof, channel_max=absmax, channel_min=-absmax, dead=absmax < 2.0, ranks_min=ranks)
    argv = FLAGS + ["-s", src, "-steps", "3", "--defend", "--defend_m", "clip", "--adv",
                    "-profile", prof]
    _same_report(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)))


def test_self_ensemble_quality_sweep_follows_quality_range(monkeypatch):
    _, cli = _cli("self_ensemble")
    seen = []
    monkeypatch.setattr(cli, "run", lambda cfg: seen.append(cfg.quality))
    cli.main(["-m", "cheng2020-gmm", "-q", "0", "--new", "-device", "cpu"])
    assert seen == [1, 2, 3, 4, 5, 6]


def test_attack_ifgsm_cli_matches_jax(tmp_path):
    j_cli, cli = _cli("attack_ifgsm")
    argv = FLAGS + ["-s", _png(tmp_path, 52), "-steps", "4"]
    _same_report(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)),
                 vi_atol=1e-2)


def test_attack_ifgsm_cli_multistart(tmp_path, capsys, monkeypatch):
    _, cli = _cli("attack_ifgsm")
    ifgsm = importlib.import_module("imagecompression_adversarial_tpu_torch.attacks.ifgsm")
    starts = []
    real = ifgsm.random_start
    monkeypatch.setattr(ifgsm, "random_start",
                        lambda x, eps, gen: starts.append(gen.initial_seed()) or real(x, eps, gen))
    avg = cli.run(parse_config(FLAGS + ["-s", _png(tmp_path, 53), "-steps", "2", "-random", "2"]))
    assert starts == [0, 0] and np.isfinite(avg["vi"])  # two starts from image 0's generator


@pytest.mark.parametrize("fast", [False, True])
def test_attack_cw_cli_matches_jax(tmp_path, fast):
    j_cli, cli = _cli("attack_cw")
    argv = FLAGS + ["-s", _png(tmp_path, 54), "-steps", "3", "-ssteps", "2"]
    ref = j_cli.run(j_parse_config(argv + J_EXTRA), fast=fast)
    _same_report(cli.run(parse_config(argv), fast=fast), ref)


def test_attack_patch_cli_matches_jax(tmp_path, capsys, monkeypatch):
    j_cli, cli = _cli("attack_patch")
    src = _png(tmp_path, 55, 160, 160)
    monkeypatch.chdir(tmp_path)
    argv = FLAGS + ["-s", src, "-steps", "3"]
    (jname, jv), = j_cli.run(j_parse_config(argv + J_EXTRA))
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    (name, v), = cli.run(parse_config(argv))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split()[:2] == jline.split()[:2]  # name and patch@(y0,x0)
    np.testing.assert_allclose(v, jv, rtol=1e-3)
    for suffix in ("advin", "advout", "oriin", "oriout"):
        im, h, w = read_image(str(tmp_path / "attack" / "patches" / f"kodim01_{suffix}.png"))
        assert (h, w) == (64, 64)


def test_attack_data_cli_matches_jax(tmp_path, capsys):
    j_cli, cli = _cli("attack_data")
    src = _png(tmp_path, 56)
    argv = FLAGS + ["-s", src, "-steps", "3", "--mask_loc", "8", "40", "16", "48"]
    assert j_cli.run(j_parse_config(argv + J_EXTRA), str(tmp_path / "jout")) == 1
    jvi = float(capsys.readouterr().out.split("vi ")[1].split()[0])
    assert cli.run(parse_config(argv), str(tmp_path / "out")) == 1
    vi = float(capsys.readouterr().out.split("vi ")[1].split()[0])
    assert abs(vi - jvi) <= 1e-3 + 1e-4  # both printed to 4 decimals
    a = read_image(str(tmp_path / "out" / "kodim01.png"))[0]
    b = read_image(str(tmp_path / "jout" / "kodim01.png"))[0]
    assert np.abs(a - b).max() <= 1.0 / 255.0 + 1e-6  # at most one 8-bit level apart
    assert np.mean(a != b) <= 1e-3


def test_attack_cv_cli_matches_jax(tmp_path, monkeypatch, capsys):
    j_cli, cli = _cli("attack_cv")
    monkeypatch.chdir(tmp_path)
    argv = FLAGS + ["-s", _png(tmp_path, 57), "-t", _png(tmp_path, 58, name="target.png"),
                    "-steps", "3", "--mask_loc", "8", "40", "16", "48", "-la_bkg_out", "0.5"]
    _same_report(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)),
                 fields=("bpp_ori", "bpp", "vi"))
    assert (tmp_path / "attack" / "targeted" / "kodim01_fake_in.png").exists()
    # the classifier variant runs and prints its label line (its parity with
    # the JAX CLI: tests/test_torch_classifier.py)
    from imagecompression_adversarial_tpu_torch.cli import classifier_train

    classifier_train.main(["-steps", "2", "-device", "cpu", "-ckpt", "cls.msgpack",
                           "-s", str(tmp_path / "none")])
    capsys.readouterr()
    res = cli.main(argv + ["--cls_ckpt", "cls.msgpack", "--cls_label", "3"])
    out = capsys.readouterr().out
    assert (f"classifier: clean-recon label {res['label_clean']} -> adv-recon label "
            f"{res['label_adv']} (target 3)") in out.splitlines()


@pytest.mark.parametrize("impl", ["host", "vmap"])
def test_attack_rd_cli_restarts_match_jax(tmp_path, monkeypatch, impl):
    j_cli, cli = _cli("attack_rd")
    j_rd = importlib.import_module("imagecompression_adversarial_tpu.attacks.rd")
    rd = importlib.import_module("imagecompression_adversarial_tpu_torch.attacks.rd")
    noises = np.random.RandomState(59).uniform(-1e-2, 1e-2, (2, 1, 64, 64, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)  # the JAX CLI's keys for image 0
    monkeypatch.setattr(j_rd, "init_noise", lambda shape, cfg, key: jnp.where(
        jnp.all(key == keys[0]), noises[0], noises[1]))
    it = iter(nchw(n) for n in noises)
    monkeypatch.setattr(rd, "init_noise", lambda shape, cfg, generator, device: next(it))
    argv = FLAGS + ["-s", _png(tmp_path, 60), "-steps", "3", "-random", "2",
                    "-restart_impl", impl, "-two_phase", "select"]
    _same_report(cli.run(parse_config(argv)), j_cli.run(j_parse_config(argv + J_EXTRA)))


def test_attack_rd_cli_batch_matches_jax(tmp_path, capsys):
    j_cli, cli = _cli("attack_rd")
    _png(tmp_path, 61, name="kodim01.png")
    _png(tmp_path, 62, name="kodim02.png")
    argv = FLAGS + ["-s", str(tmp_path / "kodim*.png"), "-steps", "3", "-attack_batch", "2",
                    "-two_phase", "select"]
    ref = j_cli.run(j_parse_config(argv + J_EXTRA))
    capsys.readouterr()
    got = cli.run(parse_config(argv))
    _same_report(got, ref)
    out = capsys.readouterr().out
    assert "kodim01.png: bpp_ori" in out and "kodim02.png: bpp_ori" in out
