"""The port's training data, checkpoints, loop and CLI (``train/data.py``,
``train/checkpoint.py``, ``train/trainer.py``, ``cli/train.py``) against the
JAX package on the CPU.

* The data streams are numpy on both sides with the same seeds and draws,
  so they must be equal exactly: ``synthetic_batches``, ``augment_dihedral``
  and ``image_folder_batches`` over PNGs the port writes (JAX reads them
  with PIL, the port with its own reader).
* ``train()`` runs 3 steps, then resumes to 5, on both sides from the hyper
  q1 demo weights (64x64, batch 2) with the same injected noise
  (``tests/torch_parity.py::same_noise``), each side in its own working
  directory.  Losses within rtol 1e-3 and parameters within 2 x 5 x lr
  (Adam's own bound over 5 steps), with at most 1e-4 of the elements more
  than lr / 10 apart: the bounds of ``tests/test_torch_train.py`` and their
  reasons.
* A step directory with neither the port's ``checkpoint.pt`` nor orbax's
  ``_CHECKPOINT_METADATA`` is refused, and nothing is written there; after
  a resume from an orbax step of the JAX package, saves remove only whole
  directories JAX's manager would remove.  The orbax reader itself is
  ``tests/test_torch_orbax.py``'s.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.config import Config as JConfig
from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu.train import step as j_step
from imagecompression_adversarial_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from imagecompression_adversarial_tpu.train.trainer import train as j_train
from imagecompression_adversarial_tpu_torch.cli import train as cli_train
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.io.image import write_image
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.train import data
from imagecompression_adversarial_tpu_torch.train.checkpoint import CheckpointManager, ckpt_dir_for
from imagecompression_adversarial_tpu_torch.train.step import create_train_state
from imagecompression_adversarial_tpu_torch.train.trainer import train
from torch_parity import (  # noqa: F401  (one_torch_thread, same_noise: fixtures)
    CKPT, REPO, hyper_models, one_torch_thread, onednn, same_noise,
)

LR = 1e-4
LOSS_RTOL = 1e-3
FAR_SHARE = 1e-4
ORBAX_DIR = REPO / "ckpts" / "adv" / "hyper-0.013-mse-0.0001-300"


# -- data -------------------------------------------------------------------


@pytest.mark.parametrize("batch, crop, seed", [(2, 64, 0), (3, 32, 7)])
def test_synthetic_and_dihedral_streams_equal_jax(batch, crop, seed):
    a, b = data.synthetic_batches(batch, crop, seed), j_data.synthetic_batches(batch, crop, seed)
    for _ in range(3):
        assert np.array_equal(next(a), next(b))
    a = data.augment_dihedral(data.synthetic_batches(batch, crop, seed), seed=seed + 1)
    b = j_data.augment_dihedral(j_data.synthetic_batches(batch, crop, seed), seed=seed + 1)
    for _ in range(4):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)


def _png_folder(root):
    """PNGs of several sizes in nested folders, one too small for the crop
    and one PNG file no reader can decode (both sides list it and skip it;
    tests/test_torch_image_formats.py mixes in JPEG and BMP files)."""
    rng = np.random.RandomState(0)
    sizes = [(80, 96), (64, 64), (120, 70), (40, 200), (100, 100), (66, 130), (90, 64)]
    for i, (h, w) in enumerate(sizes):
        sub = os.path.join(root, "a" if i % 2 else "b", "c" if i % 3 == 0 else "")
        os.makedirs(sub, exist_ok=True)
        write_image(rng.rand(1, h, w, 3).astype(np.float32), os.path.join(sub, f"im{i}.png"))
    with open(os.path.join(root, "broken.png"), "wb") as f:
        f.write(b"not an image")


def test_image_folder_batches_equal_jax(tmp_path):
    _png_folder(str(tmp_path))
    assert data.list_image_files(str(tmp_path)) == j_data.list_image_files(str(tmp_path))
    a = data.image_folder_batches(str(tmp_path), 2, crop=64, seed=3, epochs=2)
    b = j_data.image_folder_batches(str(tmp_path), 2, crop=64, seed=3, epochs=2)
    got, want = list(a), list(b)
    assert len(got) == len(want) == 6  # 6 readable images of >= 64x64 an epoch, drop-last
    for x, y in zip(got, want):
        assert x.shape == (2, 64, 64, 3) and np.array_equal(x, y)
    assert isinstance(data.make_batches(str(tmp_path), 2, 64), type(a))
    assert not np.array_equal(next(data.make_batches(None, 2, 64)), got[0])


def test_prefetch_passes_items_raises_failures_and_stops():
    assert list(data.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def failing():
        yield 1
        raise OSError("disk gone")

    stream = data.prefetch(failing())
    assert next(stream) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(stream)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    stream = data.prefetch(endless())
    assert [next(stream) for _ in range(3)] == [0, 1, 2]
    stream.close()  # stops and joins the producer


# -- checkpoints --------------------------------------------------------------


def _state(seed=0):
    model = init_model("hyper", 1, seed).requires_grad_(True)
    return create_train_state(model, LR)


def test_checkpoint_round_trip_is_exact_and_keeps_three(tmp_path):
    state = _state()
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    from imagecompression_adversarial_tpu_torch.train.step import train_step

    for _ in range(2):  # optimizer state with moments
        train_step(state, x, torch.Generator().manual_seed(1), LR, 0.0018)
    ckpts = CheckpointManager(str(tmp_path), "hyper")
    for step in range(1, 6):
        ckpts.save(step, state, extra={"epoch": 0, "loss": 1.0 / step, "lr": LR}, is_best=step == 2)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "best_loss"]
    assert ckpts.latest_step() == 5

    fresh = _state(seed=1)
    extra = ckpts.restore(fresh)
    assert extra == {"epoch": 0, "loss": 0.2, "lr": LR} and fresh.step == state.step == 2
    saved, restored = state.state_dict(), fresh.state_dict()
    for key in saved["params"]:
        assert torch.equal(saved["params"][key], restored["params"][key]), key
    for opt in ("opt_state", "aux_opt_state"):
        a, b = saved[opt]["state"], restored[opt]["state"]
        assert a.keys() == b.keys() and len(a) > 0
        for k in a:
            for name in a[k]:
                assert torch.equal(a[k][name], b[k][name]), (opt, k, name)


def test_orbax_directory_is_refused(tmp_path, monkeypatch):
    """A step directory of neither format raises on restore, naming both,
    and the trainer stops before writing anything.  After restoring a copy
    of the committed orbax step 2000, saves keep the newest three step
    numbers of both formats, remove an older orbax step whole, replace an
    orbax ``best_loss`` whole, keep a directory of neither format and leave
    step 2000's bytes as they were."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(device="cpu", model="hyper", quality=1, metric="mse", adv=True, steps=3,
                 noise=1e-4, batch_size=1)
    foreign = os.path.join(ckpt_dir_for(cfg, 0.0018), "10")
    os.makedirs(foreign)
    open(os.path.join(foreign, "notes.txt"), "w").close()
    with pytest.raises(ValueError, match="neither this port's checkpoint.pt nor an orbax"):
        CheckpointManager(os.path.dirname(foreign), "hyper").restore(_state())
    with pytest.raises(ValueError, match="neither"):
        train(cfg, max_steps=1, crop=64)
    with pytest.raises(ValueError, match="neither"):
        CheckpointManager(os.path.dirname(foreign), "hyper").save(10, _state())
    written = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert written == ["notes.txt"]

    root = tmp_path / "resume"
    shutil.copytree(ORBAX_DIR / "2000", root / "2000")
    for fake in ("1980", "1990", "best_loss"):  # orbax's commit marker alone
        (root / fake).mkdir()
        (root / fake / "_CHECKPOINT_METADATA").write_text("{}")
    (root / "1970").mkdir()
    (root / "1970" / "notes.txt").write_text("")
    before = {p: p.read_bytes() for p in (root / "2000").rglob("*") if p.is_file()}
    state = create_train_state(init_model("hyper", 4, 0).requires_grad_(True), LR)
    ckpts = CheckpointManager(str(root), "hyper")
    extra = ckpts.restore(state)
    assert state.step == 2000 and extra["lr"] == 1.5625e-07
    ckpts.save(2001, state, extra=dict(extra, epoch=0), is_best=True)
    assert sorted(os.listdir(root)) == ["1970", "1990", "2000", "2001", "best_loss"]
    assert os.listdir(root / "best_loss") == ["checkpoint.pt"]
    ckpts.save(2002, state, extra=dict(extra, epoch=0))
    assert sorted(os.listdir(root)) == ["1970", "2000", "2001", "2002", "best_loss"]
    assert {p: p.read_bytes() for p in (root / "2000").rglob("*") if p.is_file()} == before


# -- the loop ---------------------------------------------------------------


def _params_close(got, want, steps, lr=LR):
    atol = 2 * steps * lr
    far = total = 0
    for name, p in got.items():
        bound = 2 * steps * 1e-3 if name.endswith("quantiles") else atol
        diff = (p - want[name]).abs()
        assert float(diff.max()) <= bound, f"{name}: {float(diff.max())}"
        far += int((diff > lr / 10).sum()) if not name.endswith("quantiles") else 0
        total += diff.numel()
    assert far <= FAR_SHARE * total, f"{far} of {total} elements more than lr / 10 apart"


def test_train_and_resume_match_jax(tmp_path, monkeypatch, same_noise, capsys):
    jm, jp, _ = hyper_models()
    j_cfg = JConfig(model="hyper", quality=1, metric="mse", checkpoint=CKPT, batch_size=2,
                    lr_train=LR)
    cfg = Config(device="cpu", model="hyper", quality=1, metric="mse", checkpoint=CKPT,
                 batch_size=2, lr_train=LR)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    template = j_step.create_train_state(jm, jp)[0]
    for steps in (3, 5):
        monkeypatch.chdir(tmp_path / "jax")
        want = j_train(j_cfg, max_steps=steps, crop=64)
        j_state, _ = JCheckpoints(want["ckpt_dir"]).restore(template, step=steps)
        monkeypatch.chdir(tmp_path / "port")
        with onednn(False):
            got = train(cfg, max_steps=steps, crop=64)
        assert got["steps"] == want["steps"] == steps
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["best_loss"], want["best_loss"], rtol=LOSS_RTOL)
        _params_close(got["state"].model.state_dict(),
                      params_from_jax(jax.tree_util.tree_map(np.asarray, j_state.params), "hyper"),
                      steps)
        assert sorted(os.listdir(got["ckpt_dir"])) == (
            ["3", "best_loss"] if steps == 3 else ["3", "5", "best_loss"])
    assert "resume training from epoch 0 (step 3)" in capsys.readouterr().out


def test_cli_train_rd_and_adv_on_cpu(tmp_path, monkeypatch, capsys):
    """``cli.train`` on ``-device cpu`` at its 256x256 crop, batch 1: RD
    steps, then ``--adv`` through the eval at step 10 (curve line,
    checkpoint, ``-trace``), then a resume."""
    monkeypatch.chdir(tmp_path)
    base = ["-device", "cpu", "-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT,
            "-batch_size", "1"]
    summary = cli_train.main(base + ["-max_steps", "2"])
    assert summary["steps"] == 2 and np.isfinite(summary["loss"])
    assert os.path.isfile(os.path.join(summary["ckpt_dir"], "2", "checkpoint.pt"))

    adv = base + ["--adv", "-steps", "1", "-log", "curve.jsonl", "-trace", "trace"]
    summary = cli_train.main(adv + ["-max_steps", "10"])
    out = capsys.readouterr().out
    assert "TRAIN DONE:" in out and "step: 10 loss:" in out
    assert summary["timing"]["attack_steps"] == 10 and np.isfinite(summary["best_loss"])
    assert summary["ckpt_dir"].endswith(os.path.join("ckpts", "adv", "hyper-0.0018-mse-0.0001-1"))
    assert sorted(os.listdir(summary["ckpt_dir"])) == ["10", "best_loss"]
    with open("curve.jsonl") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and '"step": 10' in lines[0]
    assert os.listdir("trace") == ["train_step_2.json"]

    summary = cli_train.main(adv + ["-max_steps", "11"])
    assert "resume training from epoch 1 (step 10)" in capsys.readouterr().out
    assert summary["steps"] == 11
