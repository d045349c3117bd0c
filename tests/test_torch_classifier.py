"""The port's classifier (``models/classifier.py``), its trainer and CLI
(``cli/classifier_train.py``) and ``attack_cv --cls_ckpt`` against the JAX
package on the CPU, one torch thread.

* The MLP's logits (its NHWC flatten order) and the antialiased bilinear
  resize of a 768x512 reconstruction to 28x28 before it: atol 1e-5
  (float32 sums in another order; ``jax.image.resize(..., "bilinear")``
  antialiases, and torch's ``antialias=True`` lands ~5e-7 from it).  The
  port applies that resize as two matrix products (a deterministic
  backward on the card), held to ``F.interpolate`` at atol 1e-6.
* ``train_classifier``, 6 Adam steps (lr 1e-3) from the same carried init
  on the same synthetic stream: the final loss rtol 1e-4, every parameter
  within Adam's bound 2 x 6 x lr and at most 1e-4 of them more than
  lr / 10 apart.
* The synthetic labeled stream and the folder reader: equal to JAX's (the
  reader's resize byte-equal to Pillow's BICUBIC, which the JAX reader
  calls).
* The msgpack each package writes, read by the other: equal arrays.
* ``attack_cv --cls_ckpt`` against the JAX CLI at 64x64, 3 steps, the same
  classifier file: vi within 1e-3 dB and bpp rtol 1e-4 (the bounds of
  ``tests/test_torch_cli_attacks.py``), and the same clean and
  adversarial labels.  This is the classifier cross-entropy parity test
  that the targeted attack's tests left for the classifier's port.
"""

import importlib
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imagecompression_adversarial_tpu.config import parse_config as j_parse_config
from imagecompression_adversarial_tpu.models import classifier as j_classifier
from imagecompression_adversarial_tpu_torch.cli import classifier_train
from imagecompression_adversarial_tpu_torch.io.image import write_image
from imagecompression_adversarial_tpu_torch.io.weights import (
    classifier_from_jax,
    flax_params,
    read_msgpack,
    write_msgpack,
)
from imagecompression_adversarial_tpu_torch.models import classifier
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, CKPT, VI_ATOL, image, nchw, one_torch_thread,
)

ATOL = 1e-5
LR = 1e-3
TRAIN_STEPS = 6
PARAM_ATOL = 2 * TRAIN_STEPS * LR
FAR_SHARE = 1e-4
LOSS_RTOL = 1e-4

_J_CLS = importlib.import_module("imagecompression_adversarial_tpu.cli.classifier_train")


def _jax_params(seed=0):
    module = j_classifier.MLPClassifier()
    params = module.init(jax.random.PRNGKey(seed), np.zeros((1, 28, 28, 3), np.float32))
    return module, jax.tree_util.tree_map(np.asarray, params["params"])


def _port(params):
    module = classifier.MLPClassifier()
    module.load_state_dict(classifier_from_jax(params), strict=True)
    return module


def test_mlp_matches_jax_in_flatten_order():
    jm, params = _jax_params()
    x = np.random.RandomState(0).rand(3, 28, 28, 3).astype(np.float32)
    with torch.no_grad():
        got = _port(params)(nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, x)), atol=ATOL)
    # NCHW flattening would see another image
    assert not np.allclose(got, np.asarray(jm.apply(
        {"params": params}, x.transpose(0, 3, 1, 2).reshape(3, 28, 28, 3))), atol=1e-3)


def test_logits_fn_resize_matches_jax():
    jm, params = _jax_params(1)
    x = image(3, 512, 768)
    want = j_classifier.make_logits_fn(jm, params)(x)
    with torch.no_grad():
        got = classifier.make_logits_fn(_port(params))(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("size", [(512, 768), (64, 64), (30, 100)])
def test_resize_matrices_are_torch_antialiased_bilinear(size):
    """The logits function's two matrix products are torch's antialiased
    bilinear resize (atol 1e-6: float32 sums in another order)."""
    x = torch.from_numpy(np.random.RandomState(size[1]).rand(2, 3, *size).astype(np.float32))
    a_h = classifier.resize_matrix(size[0], 28).float()
    a_w = classifier.resize_matrix(size[1], 28).float()
    want = torch.nn.functional.interpolate(x, size=(28, 28), mode="bilinear",
                                           align_corners=False, antialias=True)
    np.testing.assert_allclose((a_h @ x @ a_w.t()).numpy(), want.numpy(), atol=1e-6)


def test_train_classifier_matches_jax(monkeypatch):
    jm, params = _jax_params(0)
    monkeypatch.setattr(classifier, "init_classifier", lambda seed, input_hw: _port(params))
    _, j_params, j_loss = j_classifier.train_classifier(
        _J_CLS._synthetic_labeled(8), steps=TRAIN_STEPS)
    module, loss = classifier.train_classifier(
        classifier_train._synthetic_labeled(8), steps=TRAIN_STEPS, device="cpu")
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    want = classifier_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    far = total = 0
    for name, p in module.state_dict().items():
        diff = (p - want[name]).abs()
        assert float(diff.max()) <= PARAM_ATOL, (name, float(diff.max()))
        far += int((diff > LR / 10).sum())
        total += diff.numel()
    assert far <= FAR_SHARE * total, f"{far} of {total} elements more than lr / 10 apart"
    first = classifier_from_jax(params)
    assert float((module.Dense_0.weight.detach() - first["Dense_0.weight"]).abs().max()) > 0


def test_synthetic_labeled_stream_equals_jax():
    ours, theirs = classifier_train._synthetic_labeled(8), _J_CLS._synthetic_labeled(8)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


@pytest.mark.parametrize("size", [(512, 768), (31, 97), (28, 28), (28, 100), (12, 9)])
def test_bicubic_resize_is_pillow(size):
    h, w = size
    img = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((28, 28)))
    np.testing.assert_array_equal(classifier_train.pillow_bicubic_resize(img, 28), want)


def test_folder_reader_equals_jax(tmp_path):
    rng = np.random.RandomState(8)
    for label in ("cat", "dog"):
        os.makedirs(tmp_path / label)
        for i in range(3):
            write_image(rng.rand(1, 40 + 7 * i, 50, 3), str(tmp_path / label / f"{i}.png"))
    gray = (rng.rand(33, 45) * 255).astype(np.uint8)
    Image.fromarray(gray, "L").save(tmp_path / "dog" / "gray.png")
    ours = classifier_train._image_folder_labeled(str(tmp_path), 4)
    theirs = _J_CLS._image_folder_labeled(str(tmp_path), 4)
    for _ in range(4):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))
    # a class folder of WebPs (lossy gray, lossless RGB) reads as JAX's
    for label, seed in (("cat", 1), ("dog", 2)):
        (tmp_path / "webp" / label).mkdir(parents=True)
        Image.fromarray(gray, "L").save(tmp_path / "webp" / label / "x.webp", quality=50 + seed)
        Image.fromarray((rng.rand(30 + seed, 47, 3) * 255).astype(np.uint8)).save(
            tmp_path / "webp" / label / "y.webp", lossless=True)
    ours = classifier_train._image_folder_labeled(str(tmp_path / "webp"), 3)
    theirs = _J_CLS._image_folder_labeled(str(tmp_path / "webp"), 3)
    for _ in range(3):
        (x, y), (jx, jy) = next(ours), next(theirs)
        np.testing.assert_array_equal(x, np.asarray(jx))
        np.testing.assert_array_equal(y, np.asarray(jy))


def test_classifier_msgpack_crosses_packages(tmp_path, capsys):
    # the port's CLI writes a file the JAX package restores
    path = str(tmp_path / "port" / "cls.msgpack")
    loss = classifier_train.main(["-steps", "3", "-device", "cpu", "-ckpt", path,
                                  "-s", str(tmp_path / "none")])
    assert capsys.readouterr().out.strip() == f"final loss {loss:.4f}; saved classifier -> {path}"
    _, template = _jax_params()
    with open(path, "rb") as f:
        restored = flax.serialization.from_bytes(template, f.read())
    for mod, node in read_msgpack(path).items():
        for leaf, value in node.items():
            np.testing.assert_array_equal(np.asarray(restored[mod][leaf]), value)
            assert restored[mod][leaf].shape == template[mod][leaf].shape
    # and the JAX package's bytes are the port's
    with open(path, "rb") as f:
        assert f.read() == flax.serialization.to_bytes(read_msgpack(path))
    # a file the JAX package writes, through the port's loader
    _, params = _jax_params(4)
    j_path = str(tmp_path / "jax.msgpack")
    with open(j_path, "wb") as f:
        f.write(flax.serialization.to_bytes(params))
    got = flax_params(_port(read_msgpack(j_path)))
    for mod, node in params.items():
        for leaf, value in node.items():
            np.testing.assert_array_equal(got[mod][leaf], value)


def test_attack_cv_cls_ckpt_matches_jax(tmp_path, monkeypatch, capsys):
    j_cli = importlib.import_module("imagecompression_adversarial_tpu.cli.attack_cv")
    cli = importlib.import_module("imagecompression_adversarial_tpu_torch.cli.attack_cv")
    monkeypatch.chdir(tmp_path)
    _, params = _jax_params(5)
    cls = str(tmp_path / "cls.msgpack")
    write_msgpack(cls, params)
    src = str(tmp_path / "kodim01.png")
    write_image(image(60), src)
    argv = ["-m", "hyper", "-q", "1", "-metric", "mse", "-ckpt", CKPT, "-device", "cpu",
            "-s", src, "-steps", "3"]
    extra = ["--cls_ckpt", cls, "--cls_label", "3"]
    ref = j_cli.run(j_parse_config(argv + ["-compile_cache", "none"]), cls_ckpt=cls, cls_label=3)
    j_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("classifier:")]
    got = cli.main(argv + extra)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("classifier:")]
    assert abs(got["vi"] - ref["vi"]) <= VI_ATOL, (got["vi"], ref["vi"])
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(got[k], ref[k], rtol=BPP_RTOL, err_msg=k)
    assert len(j_lines) == 1 and lines == j_lines
    assert lines[0].endswith("(target 3)")
    assert (tmp_path / "attack" / "targeted" / "kodim01_fake_out.png").exists()
