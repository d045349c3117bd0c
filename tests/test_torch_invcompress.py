"""The port's invcompress family (``models/invcompress.py``) against the
JAX package on the CPU.

Its latent is fixed at 768 channels (207M parameters), so the submodules
run at small widths and the whole codec once at 64x64, on one set of
weights for the file: the port's seeded ``init_model`` with every
parameter moved by 0.01 x normal noise (so the zero-initialized couplings
act), handed to JAX through ``torch_parity.jax_params_from_port``.
Tolerances, those of ``tests/test_torch_codecs.py``: submodules atol 1e-5
(their inverse too); forwards in ``noise`` (the same numpy noise on both
sides), ``dequantize`` and ``ste`` with x_hat within 1e-4 of its largest
magnitude, likelihoods atol 1e-4, bpp rtol 1e-4; the coder's round trip
exact.

The 3-step ``select`` attack is held looser, to bounds measured against a
float64 run of the port: at most 0.5% of ``im_``'s elements more than 1e-4
from JAX's and none more than 2e-3, vi within 0.05 dB and bpp rtol 2e-3.
The codec is invertible, so the output loss's gradient is the codec's
rounding error, which is near zero on many pixels; Adam's first step moves
each pixel by lr = 0.01 in the sign of its gradient, so float32 error flips
pixels.  Measured: JAX's ``im_`` 7.1e-4 from the float64 run's, the port's
1.1e-3, the two 1.3e-3 apart on 0.18% of the elements (> 1e-4); vi JAX
22.3691, float64 22.3691, port 22.3870 dB (the last step's input MSE sits
at the budget, and the port's run lands on its other side); bpp 27.555
against 27.531.  Another seed (3) put all three runs 2.4e-2 apart, JAX and
the port equally far from float64.  ``g_s(g_a(x))`` returns x within 1e-4, the JAX
package's own bound (``tests/test_invcompress.py``).
"""

import jax
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.models import invcompress as j_inv
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
from imagecompression_adversarial_tpu_torch.entropy.codec import RealCodec
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import init_model, invcompress
from torch_parity import (  # noqa: F401  (one_torch_thread, shape_noise: fixtures)
    image, jax_params_from_port, nchw, nhwc, one_torch_thread, onednn, perturb_, shape_noise,
)


@pytest.fixture(scope="module")
def codec():
    """(JAX module, numpy params, port model) of invcompress on one set of weights."""
    model = perturb_(init_model("invcompress", 1, seed=4), 0.01).requires_grad_(False)
    jm = j_init_model("invcompress", 1)
    return jm, jax_params_from_port(model, jm, "invcompress"), model


def test_squeeze_matches_jax_and_inverts():
    x = np.random.RandomState(0).rand(2, 8, 12, 3).astype(np.float32)
    y = invcompress.squeeze2(nchw(x))
    assert y.shape == (2, 12, 4, 6)
    np.testing.assert_array_equal(nhwc(y), np.asarray(j_inv.squeeze2(x)))
    np.testing.assert_array_equal(nhwc(invcompress.unsqueeze2(y)), x)


def _layer(jmod, layer, x, top="inv"):
    """JAX init of ``jmod`` moved by seeded noise, loaded into ``layer``."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jmod.init(jax.random.PRNGKey(1), x)["params"])
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                                    params)
    state = params_from_jax({top: params}, "invcompress")
    layer.load_state_dict({k[len(top) + 1:]: v for k, v in state.items()}, strict=True)
    return params, layer.requires_grad_(False)


# (name, JAX layer, port layer, channels)
_LAYERS = [
    ("coupling_k5", lambda: j_inv.CouplingLayer(3, 9, 5),
     lambda: invcompress.CouplingLayer(3, 9, 5), 12),
    ("coupling_k3", lambda: j_inv.CouplingLayer(12, 36, 3),
     lambda: invcompress.CouplingLayer(12, 36, 3), 48),
    ("invertible_1x1", lambda: j_inv.InvertibleConv1x1(12),
     lambda: invcompress.InvertibleConv1x1(12), 12),
]


@pytest.mark.parametrize("name, jlayer, layer, c", _LAYERS, ids=[c[0] for c in _LAYERS])
def test_submodule_and_its_inverse_match_jax(name, jlayer, layer, c):
    x = np.random.RandomState(2).randn(1, 6, 8, c).astype(np.float32)
    jmod = jlayer()
    params, mod = _layer(jmod, layer(), x)
    for rev in (False, True):
        ref = np.asarray(jmod.apply({"params": params}, x, rev=rev))
        np.testing.assert_allclose(nhwc(mod(nchw(x), rev=rev)), ref, atol=1e-5)
    np.testing.assert_allclose(nhwc(mod(mod(nchw(x)), rev=True)), x, atol=1e-5)


def test_invcomp_is_invertible(codec):
    _, _, model = codec
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    y = model.g_a(x)
    assert y.shape == (1, 768, 4, 4)
    np.testing.assert_allclose(model.g_s(y).numpy(), x.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["noise", "dequantize", "ste"])
def test_forward_matches_jax(codec, mode, shape_noise):
    jm, jp, model = codec
    x = image(0)
    jr = jm.apply({"params": jp}, x, quant_mode=mode, rngs={"quant": jax.random.PRNGKey(0)})
    tr = model(nchw(x), quant_mode=mode, generator=torch.Generator().manual_seed(0))
    ref = np.asarray(jr["x_hat"])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(nhwc(tr["x_hat"]), ref, atol=1e-4 * scale, rtol=0)
    for k, lik in tr["likelihoods"].items():
        np.testing.assert_allclose(nhwc(lik), np.asarray(jr["likelihoods"][k]), atol=1e-4)
    np.testing.assert_allclose(float(bpp_from_likelihoods(tr["likelihoods"], 64 * 64)),
                               float(j_bpp(jr["likelihoods"], 64 * 64)), rtol=1e-4)


def test_attack_matches_jax(codec):
    jm, jp, model = codec
    assert not model.supports_phase_synthesis
    x = image(1)
    kw = dict(steps=3, two_phase_impl="select")
    jres = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    with onednn(False):
        res = make_attack_fn(model, RDAttackConfig(**kw))(nchw(x))
    im_ = nhwc(res["im_"])
    diff = np.abs(im_ - np.asarray(jres["im_"]))
    assert (diff > 1e-4).mean() <= 5e-3 and diff.max() <= 2e-3
    assert abs(res["vi"].item() - float(jres["vi"])) <= 0.05
    np.testing.assert_allclose(res["bpp_ori"].item(), float(jres["bpp_ori"]), rtol=1e-4)
    np.testing.assert_allclose(res["bpp"].item(), float(jres["bpp"]), rtol=2e-3)
    assert np.abs(im_ - x).max() > 1e-3


def test_coder_round_trip(codec):
    _, _, model = codec
    rc = RealCodec(model)
    trace = {}
    out = rc.compress(nchw(image(2)), trace)
    y_hat = rc.decode_latent(out["strings"], out["shape"])
    assert torch.equal(y_hat, trace["y_hat"])
    assert rc.synthesize(y_hat).shape == (1, 3, 64, 64)
