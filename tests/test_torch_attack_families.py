"""The port's RD attack on the slice-2 families vs JAX, on the CPU: a 6-step
``select`` attack at 64x64 on cheng2020-gmm (the committed q3 demo weights)
and on context (q1, seeded weights), and the debug fixture's branches
(unclipped input, its noise init) with the same noise handed to both sides.

Weights: the demo checkpoint for cheng2020-gmm; for context and debug the
port's seeded ``init_model`` handed to JAX through its own converter
(``io/convert.py::convert_state_dict``), so both sides hold the same numpy
arrays.  Tolerances:

* context: those of slice 1 (``tests/test_torch_attack_rd.py``): ``im_``
  atol 1e-5 without oneDNN and 1e-4 with it, ``vi`` abs 1e-3, bpp rtol 1e-4.
  Measured: 7.6e-6 and 2.8e-5.
* cheng2020-gmm: ``im_`` atol 5e-4 either way, ``vi`` and bpp as above.  Its
  g_a + g_s_phase runs ~65 float32 convs in sequence (hyper's 8), and Adam
  (lr / eps = 1e6) turns gradient error on near-zero-gradient pixels into
  noise error: JAX's own float32 trajectory sat 1.7e-4 from a float64 run
  of the port after 6 steps, and the port's float32 run (no oneDNN) 9.8e-6
  from it.  Measured against JAX: 1.7e-4 without oneDNN, 1.9e-5 with it.
* debug loss and its noise gradient: atol 1e-6 / rtol 1e-5 (one 3x3 conv
  each way and the hyper path).  The 6-step debug attack (seeded weights):
  ``im_`` atol 5e-4, ``vi`` and bpp as above.  Its random 192-channel
  full-resolution latent leaves many pixels with gradients near Adam's eps:
  already after 1 step JAX sat 3.6e-5 and the port 3.5e-5 from a float64
  run of the port, after 2 steps 6.5e-5 and 2.0e-4.  Measured against JAX
  after 6 steps: 6.0e-5.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.attacks import common as j_common
from imagecompression_adversarial_tpu.attacks import rd as j_rd
from imagecompression_adversarial_tpu.io.convert import convert_state_dict
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, init_noise, make_attack_fn
from imagecompression_adversarial_tpu_torch.attacks import rd
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.runtime import load_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo",
                    "cheng2020-gmm-q3-mse-synthetic.msgpack")


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


_MODELS = {}


def _models(fam):
    """(JAX module, numpy params, port model) on the same weights."""
    if fam not in _MODELS:
        quality = 3 if fam == "cheng2020-gmm" else 1
        if fam == "cheng2020-gmm":
            model = load_model(Config(device="cpu", model=fam, quality=quality, checkpoint=CKPT))
            with open(CKPT, "rb") as f:
                jp = flax.serialization.msgpack_restore(f.read())
        else:
            model = init_model(fam, quality, seed=3).requires_grad_(False)
            jp = convert_state_dict(model.state_dict(), fam)
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
        _MODELS[fam] = (j_init_model(fam, quality), jp, model)
    return _MODELS[fam]


_JAX_RESULTS = {}
# family -> im_ atol, by whether torch's CPU convolutions use oneDNN (docstring)
_IM_ATOL = {"context": {False: 1e-5, True: 1e-4}, "cheng2020-gmm": {False: 5e-4, True: 5e-4}}


@pytest.mark.parametrize("onednn", [False, True])
@pytest.mark.parametrize("fam", ["cheng2020-gmm", "context"])
def test_select_attack_matches_jax(fam, onednn):
    jm, jp, model = _models(fam)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    kw = dict(steps=6, two_phase_impl="select")
    if fam not in _JAX_RESULTS:
        _JAX_RESULTS[fam] = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    jres = _JAX_RESULTS[fam]
    with torch.backends.mkldnn.flags(enabled=onednn):
        res = make_attack_fn(model, RDAttackConfig(**kw))(_nchw(x))
    im_ = _nhwc(res["im_"])
    np.testing.assert_allclose(im_, np.asarray(jres["im_"]), atol=_IM_ATOL[fam][onednn], rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4)
    assert np.abs(im_ - x).max() <= 16.0 / 255.0 + 1e-6
    assert np.abs(im_ - x).max() > 1e-3  # the attack moved the input


@pytest.mark.parametrize("amplitude", [0.01, 0.05])  # output phase, input phase
def test_debug_loss_matches_jax_with_unclipped_input(amplitude):
    jm, jp, model = _models("debug")
    rng = np.random.RandomState(4)
    x = rng.rand(1, 32, 32, 3).astype(np.float32)
    x[:, :4] = 0.0  # inputs at the edge of [0, 1] that the noise pushes out
    x[:, -4:] = 1.0
    noise = rng.uniform(-amplitude, amplitude, x.shape).astype(np.float32)
    output_s = np.clip(np.asarray(jm.apply({"params": jp}, x, quant_mode="dequantize")["x_hat"]),
                       0.0, 1.0)
    jcfg, cfg = JConfig(debug_model=True), RDAttackConfig(debug_model=True)
    apply_fn = lambda im, quant_mode: jm.apply({"params": jp}, im, quant_mode=quant_mode)  # noqa: E731
    (jloss, (jli, jlo)), jgrad = jax.value_and_grad(
        lambda n: j_rd._attack_loss(apply_fn, x, output_s, n, jcfg), has_aux=True
    )(jnp.asarray(noise))
    tn = _nchw(noise).requires_grad_(True)
    loss, (li, lo) = rd._attack_loss(model, _nchw(x), _nchw(output_s), tn, cfg, phase=False)
    (grad,) = torch.autograd.grad(loss, tn)
    for got, ref in ((loss, jloss), (li, jli), (lo, jlo)):
        np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(grad), np.asarray(jgrad), atol=1e-6, rtol=1e-5)
    # the input is x + noise, not clipped to [0, 1]
    np.testing.assert_allclose(li.item(), float(np.mean(noise.astype(np.float64) ** 2)), rtol=1e-5)
    assert (li.item() > cfg.noise_threshold) == (amplitude == 0.05)


def test_debug_noise_init_draws_from_the_budget():
    cfg = RDAttackConfig(debug_model=True, noise_threshold=4e-4)
    n = init_noise((1, 3, 64, 64), cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    jn = np.asarray(j_common.init_noise((1, 64, 64, 3), JConfig(debug_model=True, noise_threshold=4e-4),
                                        jax.random.PRNGKey(0)))
    for a in (n.numpy(), jn):
        assert np.abs(a).max() <= 0.02 and np.abs(a).max() > 0.0199
        assert abs(a.mean()) < 1e-3
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        init_noise((1, 3, 8, 8), cfg, None, torch.device("cpu"))
    assert not torch.count_nonzero(init_noise((1, 3, 8, 8), RDAttackConfig(), None,
                                              torch.device("cpu")))


def test_debug_attack_matches_jax_from_the_same_noise(monkeypatch):
    jm, jp, model = _models("debug")
    x = np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32)
    noise0 = np.random.RandomState(6).uniform(-0.01, 0.01, x.shape).astype(np.float32)
    monkeypatch.setattr(j_rd, "init_noise", lambda shape, cfg, key: jnp.asarray(noise0))
    monkeypatch.setattr(rd, "init_noise", lambda shape, cfg, generator, device: _nchw(noise0))
    kw = dict(steps=6, two_phase_impl="select", debug_model=True)
    jres = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    with torch.backends.mkldnn.flags(enabled=False):
        attack = make_attack_fn(model, RDAttackConfig(**kw))
        res = attack(_nchw(x))
    np.testing.assert_allclose(_nhwc(res["im_"]), np.asarray(jres["im_"]), atol=5e-4, rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4)
    # the auto phase-space loss stays off for the debug fixture, as in JAX
    cheng = _models("cheng2020-gmm")[2]
    assert not rd._resolve(cheng, RDAttackConfig(debug_model=True)).phase_space_loss
    assert rd._resolve(cheng, RDAttackConfig()).phase_space_loss
