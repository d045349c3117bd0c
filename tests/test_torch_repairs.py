"""Repairs of the port against the reference, on the CPU:

* checkpoints: a codec trained by ``cli.train`` loads through
  ``load_checkpoint`` (its ``checkpoint.pt``, its step directory, its
  ``best_loss`` directory) with the trained parameters exactly, and
  ``cli.attack_rd -ckpt`` attacks it;
* training data: a folder holding a WebP (written here with PIL) or a
  progressive JPEG streams JAX's batches, and ``cli.train -data`` takes
  its step on the WebP one; a folder whose images yield no batch raises,
  naming what it skipped;
* the CLI: ``attack_rd -trace DIR`` writes a chrome trace and prints the
  ``[trace]`` line; ``--eval``, ``-r``, ``--fintune`` and ``-compile_cache``
  parse as on the JAX CLI and change nothing; ``-m fic`` without restarts
  warns as the JAX CLI does;
* Kodak-24: the port's generator writes the pixels of
  ``scripts/make_kodak24.py`` exactly.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.cli import attack_rd
from imagecompression_adversarial_tpu_torch.cli import train as cli_train
from imagecompression_adversarial_tpu_torch.cli.make_kodak24 import make_kodak24
from imagecompression_adversarial_tpu_torch.config import Config, parse_config
from imagecompression_adversarial_tpu_torch.io.image import read_image, write_image
from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint
from imagecompression_adversarial_tpu_torch.train import data
from torch_parity import CKPT, REPO, one_torch_thread  # noqa: F401  (fixture)


def _png(path, h=64, w=64, seed=0):
    write_image(np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32), str(path))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 RD steps of hyper q1 from the demo weights through ``cli.train``."""
    work = tmp_path_factory.mktemp("train")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        summary = cli_train.main(["-device", "cpu", "-m", "hyper", "-q", "1", "-metric", "mse",
                                  "-ckpt", CKPT, "-batch_size", "1", "-max_steps", "2"])
    finally:
        os.chdir(cwd)
    return summary, work


def test_load_checkpoint_reads_a_trained_codec(trained):
    summary, _ = trained
    want = summary["state"].model.state_dict()
    step_dir = os.path.join(summary["ckpt_dir"], "2")
    for path in (os.path.join(step_dir, "checkpoint.pt"), step_dir,
                 os.path.join(summary["ckpt_dir"], "best_loss")):
        got = load_checkpoint(path, "hyper")
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v.float()), (path, k)
    with pytest.raises(ValueError, match="without a checkpoint.pt"):
        load_checkpoint(summary["ckpt_dir"], "hyper")


def test_attack_rd_attacks_a_trained_codec(trained, tmp_path, monkeypatch, capsys):
    summary, _ = trained
    src = _png(tmp_path / "im.png")
    monkeypatch.chdir(tmp_path)
    attack_rd.main(["-m", "hyper", "-q", "1", "-metric", "mse", "-device", "cpu",
                    "-ckpt", os.path.join(summary["ckpt_dir"], "2"), "-s", src, "-steps", "3"])
    out = capsys.readouterr().out
    assert "im.png: bpp_ori" in out and "AVG:" in out
    # the attacked codec is the trained one, not the demo it started from
    cfg = parse_config(["-m", "hyper", "-q", "1", "-device", "cpu", "-ckpt",
                        os.path.join(summary["ckpt_dir"], "2")])
    from imagecompression_adversarial_tpu_torch.runtime import load_model

    trained_model = load_model(cfg)
    demo = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    assert any(not torch.equal(a, b) for a, b in zip(trained_model.state_dict().values(),
                                                     demo.state_dict().values()))


def test_a_jpeg_folder_raises_instead_of_spinning(tmp_path, monkeypatch):
    """The stream lists JAX's five extensions and reads baseline and
    progressive JPEGs and WebPs: a WebP or a progressive JPEG beside a PNG
    streams the crops of PIL's pixels, and ``cli.train -data`` takes its
    step on the WebP folder."""
    rgb = (np.random.RandomState(0).rand(300, 300, 3) * 255).astype(np.uint8)
    for kind, name, kwargs in (("webp", "a.webp", {}), ("progressive", "b.jpg",
                                                        {"progressive": True})):
        folder = tmp_path / kind
        folder.mkdir()
        Image.fromarray(rgb).save(folder / name, **kwargs)
        _png(folder / "c.png", 300, 300)
        assert data.list_image_files(str(folder)) == [str(folder / name), str(folder / "c.png")]
        ours = list(data.image_folder_batches(str(folder), 1, crop=256, epochs=1))
        theirs = list(j_data.image_folder_batches(str(folder), 1, crop=256, epochs=1))
        assert len(ours) == len(theirs) == 2
        for got, want in zip(ours, theirs):
            np.testing.assert_array_equal(got, want)
        assert next(data.make_batches(str(folder), 1, 256)).shape == (1, 256, 256, 3)
    monkeypatch.chdir(tmp_path)
    summary = cli_train.main(["-device", "cpu", "-m", "hyper", "-q", "1", "-metric", "mse",
                              "-ckpt", CKPT, "-batch_size", "2", "-max_steps", "1",
                              "-data", str(tmp_path / "webp")])
    assert summary["steps"] == 1 and np.isfinite(summary["loss"])


def test_an_epoch_without_a_batch_raises_naming_the_skipped_files(tmp_path):
    _png(tmp_path / "small.png", 32, 32)
    (tmp_path / "broken.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match=r"2 PNG files .* 2 skipped \(1 smaller than the "
                                         r"64x64 crop, 1 unreadable \(ValueError\)\)"):
        list(data.image_folder_batches(str(tmp_path), 1, crop=64, epochs=None))
    # one readable image but a batch of two: no batch either
    _png(tmp_path / "big.png", 80, 80)
    with pytest.raises(ValueError, match="gave no batch of 2"):
        list(data.image_folder_batches(str(tmp_path), 2, crop=64, epochs=None))
    assert len(list(data.image_folder_batches(str(tmp_path), 1, crop=64, epochs=3))) == 3


def test_attack_rd_trace_writes_a_chrome_trace(tmp_path, monkeypatch, capsys):
    src = _png(tmp_path / "im.png")
    monkeypatch.chdir(tmp_path)
    attack_rd.main(["-m", "hyper", "-q", "1", "-metric", "mse", "-device", "cpu", "-ckpt", CKPT,
                    "-s", src, "-steps", "2", "-trace", "tr"])
    out = capsys.readouterr().out
    path = os.path.join("tr", "attack_rd.json")
    assert f"[trace] torch.profiler trace written to {path}" in out
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_jax_only_flags_parse_and_change_nothing():
    line = ["-m", "hyper", "-q", "2", "-steps", "7", "--eval", "-r", "--fintune",
            "-compile_cache", "none", "-re", "3"]
    got, plain = parse_config(line), parse_config(line[:6] + line[11:])
    assert got == plain and got.recompress == 3 and got.steps == 7
    j = j_parse_config(line)  # the JAX CLI takes the same line
    assert (j.model, j.quality, j.steps, j.recompress) == (got.model, got.quality, 7, 3)


@pytest.mark.parametrize("restarts, warns", [("1", True), ("2", False)])
def test_fic_warns_without_restarts(monkeypatch, capsys, restarts, warns):
    monkeypatch.setattr(attack_rd, "run", lambda cfg: None)
    attack_rd.main(["-m", "fic", "-q", "3", "-device", "cpu", "-random", restarts])
    assert ("WARNING: -m fic with zero noise init" in capsys.readouterr().out) == warns


def _script_kodak24():
    spec = importlib.util.spec_from_file_location("make_kodak24",
                                                  REPO / "scripts" / "make_kodak24.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kodak24_generator_writes_the_scripts_pixels(tmp_path, capsys):
    make_kodak24(str(tmp_path / "port"))
    _script_kodak24().main(str(tmp_path / "script"))
    names = sorted(os.listdir(tmp_path / "script"))
    assert names == [f"kodim{i:02d}.png" for i in range(1, 25)]
    assert sorted(os.listdir(tmp_path / "port")) == names
    portrait = 0
    for name in names:
        want = np.asarray(Image.open(tmp_path / "script" / name).convert("RGB"))
        got, h, w = read_image(str(tmp_path / "port" / name), padding=1)
        portrait += h > w
        assert want.shape == (h, w, 3)
        np.testing.assert_array_equal(np.round(got[0] * 255).astype(np.uint8), want)
    assert portrait == 6
