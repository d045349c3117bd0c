"""``cli/export_ckpt.py`` (the port of ``scripts/export_ckpt.py``) against
the JAX exporter's bytes and both loaders.

* The committed ``best_loss`` of ``ckpts/adv/hyper-0.013-mse-0.0001-300``
  exports to ``ckpts/demo/hyper-q4-mse-advtuned2000.msgpack`` byte for
  byte (the JAX script's output); with ``--fp32`` to the bytes of
  ``flax.serialization.to_bytes`` of the item's params.
* A ``checkpoint.pt`` of the port's trainer (one CPU step of hyper q1 at
  64x64) exports to a file that JAX's ``runtime.load_model`` and the
  port's ``load_checkpoint`` both read.  Both forwards (``quant_mode=
  "none"`` at 64x64) agree at the codec parity tests' bounds: x_hat atol
  1e-4, likelihoods atol 1e-4.  With ``--fp32`` the port reads back the
  trained state exactly; with float16 each parameter is its float16
  rounding.
"""

from __future__ import annotations

import hashlib
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.config import Config as JConfig
from imagecompression_adversarial_tpu.runtime import load_model as j_load_model
from imagecompression_adversarial_tpu_torch.cli import export_ckpt
from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint
from imagecompression_adversarial_tpu_torch.models.registry import init_model
from imagecompression_adversarial_tpu_torch.train import orbax
from imagecompression_adversarial_tpu_torch.train.checkpoint import CheckpointManager
from imagecompression_adversarial_tpu_torch.train.step import create_train_state, train_step
from torch_parity import REPO, nchw, nhwc, one_torch_thread  # noqa: F401

RUN = str(REPO / "ckpts" / "adv" / "hyper-0.013-mse-0.0001-300")
DEMO = REPO / "ckpts" / "demo" / "hyper-q4-mse-advtuned2000.msgpack"
DEMO_SHA256 = "348234705f09a080fedd87ffecde5a0c707256326f49eeaa290bf7ec270aef2e"
ATOL = 1e-4


def _sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_best_loss_exports_the_committed_demo_bytes(tmp_path, capsys):
    out = str(tmp_path / "demo.msgpack")
    line = export_ckpt.main([RUN, "-m", "hyper", "-q", "4", "-o", out])
    assert _sha256(DEMO) == DEMO_SHA256
    with open(out, "rb") as a, open(DEMO, "rb") as b:
        assert a.read() == b.read()
    assert line == (f"exported {out} (10.2 MB, fp16) from step 1560 loss 7.556025505065918")
    assert capsys.readouterr().out.strip() == line


def test_fp32_export_is_flax_to_bytes_of_the_item(tmp_path):
    out = str(tmp_path / "fp32.msgpack")
    line = export_ckpt.export(os.path.join(RUN, "best_loss"), "hyper", 4, out, fp32=True)
    tree, _ = orbax.read_item(os.path.join(RUN, "best_loss"))
    want = flax.serialization.to_bytes(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree["state"]["params"]))
    with open(out, "rb") as f:
        assert f.read() == want
    assert "(20.3 MB, fp32) from step 1560" in line


def test_wrong_codec_is_refused(tmp_path):
    # q6 is N=192, M=320; the run is q4 (N=128, M=192)
    with pytest.raises(RuntimeError, match="size mismatch"):
        export_ckpt.export(RUN, "hyper", 6, str(tmp_path / "x.msgpack"))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port training directory after one CPU step of hyper q1 (seeded
    weights, a seeded 64x64 batch), and the trained model."""
    root = tmp_path_factory.mktemp("port_run")
    state = create_train_state(init_model("hyper", 1, 0).requires_grad_(True), 1e-4)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    logs = train_step(state, x, torch.Generator().manual_seed(1), 1e-4, 0.0018)
    CheckpointManager(str(root), "hyper").save(
        1, state, extra={"epoch": 0, "loss": float(logs["loss"]), "lr": 1e-4}, is_best=True)
    return str(root), state.model.requires_grad_(False), float(logs["loss"])


@pytest.mark.parametrize("fp32", [False, True], ids=["fp16", "fp32"])
def test_port_checkpoint_loads_in_both_loaders(port_run, tmp_path, fp32):
    root, trained, loss = port_run
    out = str(tmp_path / "port.msgpack")
    line = export_ckpt.export(root, "hyper", 1, out, fp32=fp32)
    assert line.endswith(f"{'fp32' if fp32 else 'fp16'}) from step 1 loss {loss}")

    port = load_checkpoint(out, "hyper")
    for key, value in trained.state_dict().items():
        want = value if fp32 else value.half().float()
        assert torch.equal(port[key], want), key
    model = init_model("hyper", 1)
    model.load_state_dict(port, strict=True)
    model.requires_grad_(False)

    jm, jp = j_load_model(JConfig(model="hyper", quality=1, checkpoint=out))
    x = np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32)
    jr = jm.apply({"params": jp}, x, quant_mode="none")
    tr = model(nchw(x), quant_mode="none")
    np.testing.assert_allclose(nhwc(tr["x_hat"]), np.asarray(jr["x_hat"]), atol=ATOL, rtol=0)
    for k, lik in tr["likelihoods"].items():
        np.testing.assert_allclose(nhwc(lik), np.asarray(jr["likelihoods"][k]), atol=ATOL)
