"""The port's Gaussian-mixture entropy model (``entropy/gaussian.py``) and
the cheng2020-gmm codec on the committed demo checkpoint vs JAX, on the CPU.

Tolerances: likelihoods atol 1e-6 (float32 erfc chains and a softmax,
values in (0, 1]); their gradients atol 1e-6 / rtol 1e-5; the K=1 mixture
equals the single Gaussian exactly.  The codec forward at 64x64 on the
demo weights (q3, N=128): x_hat atol 1e-4, every likelihood atol 1e-4, bpp
rtol 1e-4 (float32 convolutions through ~65 convs in sequence, and rounding
of latents that may sit within float32 error of a half-integer).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.entropy.gaussian import (
    gaussian_mixture_conditional as j_gmc,
    gaussian_mixture_likelihood as j_gml,
)
from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.entropy import (
    gaussian_likelihood,
    gaussian_mixture_conditional,
    gaussian_mixture_likelihood,
)
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax, read_msgpack
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.models.codecs import split_gmm_params
from imagecompression_adversarial_tpu_torch.runtime import load_model

CKPT = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo",
                    "cheng2020-gmm-q3-mse-synthetic.msgpack")


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _mixture(seed, k=3, shape=(2, 5, 6, 4)):
    """Quantized values and per-component scales (some below the 0.11
    bound, some large), means and logits."""
    rng = np.random.RandomState(seed)
    values = np.round(rng.randn(*shape) * 3).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(50.0), shape + (k,))).astype(np.float32)
    means = (rng.randn(*shape, k) * 2).astype(np.float32)
    logits = (rng.randn(*shape, k) * 2).astype(np.float32)
    return values, scales, means, logits


def test_mixture_likelihood_and_gradients_match_jax():
    values, scales, means, logits = _mixture(0)
    w = np.random.RandomState(1).randn(*values.shape).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (scales, means, logits)]
    jlik = j_gml(jnp.asarray(values), *jargs)
    jgrads = jax.grad(lambda s, m, l: jnp.sum(w * j_gml(jnp.asarray(values), s, m, l)),
                      argnums=(0, 1, 2))(*jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in (scales, means, logits)]
    tlik = gaussian_mixture_likelihood(torch.tensor(values), *targs)
    (tlik * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tlik.detach().numpy(), np.asarray(jlik), atol=1e-6)
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mode", ["dequantize", "ste", "none"])
def test_mixture_conditional_matches_jax(mode):
    _, scales, means, logits = _mixture(2)
    y = (np.random.RandomState(3).randn(*scales.shape[:-1]) * 4).astype(np.float32)
    jy, jlik = j_gmc(*(jnp.asarray(a) for a in (y, scales, means, logits)), quant_mode=mode)
    ty, tlik = gaussian_mixture_conditional(*(torch.tensor(a) for a in (y, scales, means, logits)),
                                            quant_mode=mode)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))  # means-free rounding
    np.testing.assert_allclose(tlik.numpy(), np.asarray(jlik), atol=1e-6)
    assert tlik.min().item() >= np.float32(1e-9)


def test_one_component_mixture_is_the_single_gaussian():
    values, scales, means, logits = _mixture(4, k=1)
    scales = np.minimum(scales, 200.0)  # the single Gaussian also clamps at 256
    got = gaussian_mixture_likelihood(*(torch.tensor(a) for a in (values, scales, means, logits)))
    ref = gaussian_likelihood(torch.tensor(values), torch.tensor(scales[..., 0]),
                              torch.tensor(means[..., 0]))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_gmm_head_channels_split_as_3_k_m():
    k, m = 3, 5
    gp = np.random.RandomState(5).randn(2, 4, 3, 3 * k * m).astype(np.float32)  # NHWC
    ref = gp.reshape(2, 4, 3, 3, k, m).transpose(0, 1, 2, 5, 4, 3)  # as JAX's from_latent
    for got, t in zip(split_gmm_params(_nchw(gp), k), range(3)):
        assert got.shape == (2, m, 4, 3, k)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1, 4).numpy(), ref[..., t])


@pytest.fixture(scope="module")
def demo():
    with open(CKPT, "rb") as f:
        jp = flax.serialization.msgpack_restore(f.read())
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    model = load_model(Config(device="cpu", model="cheng2020-gmm", quality=3, checkpoint=CKPT))
    return j_init_model("cheng2020-gmm", 3), jp, model


def _leaf_count(tree):
    return sum(_leaf_count(v) if isinstance(v, dict) else 1 for v in tree.values())


def test_demo_checkpoint_maps_every_leaf_once():
    tree = read_msgpack(CKPT)
    state = params_from_jax(tree, "cheng2020-gmm")
    model_state = init_model("cheng2020-gmm", 3).state_dict()
    assert _leaf_count(tree) == len(state) == len(model_state) == 275
    assert state.keys() == model_state.keys()
    for k, v in model_state.items():
        assert state[k].shape == v.shape, k
    assert sum(v.numel() for v in state.values()) == 13_489_725
    for name in ("g_a.attn_1.trunk_0.conv1.weight", "g_a.attn_2.mask_conv.bias",
                 "g_s.1.subpel_conv.0.weight", "g_s.7.0.weight", "h_s.2.0.weight",
                 "context_prediction.weight", "entropy_parameters.4.weight", "g_a.0.gdn.gamma"):
        assert name in state, name


@pytest.mark.parametrize("mode", ["dequantize", "none"])
def test_demo_forward_matches_jax(demo, mode):
    jm, jp, model = demo
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    jr = jm.apply({"params": jp}, x, quant_mode=mode)
    tr = model(_nchw(x), quant_mode=mode)
    np.testing.assert_allclose(_nhwc(tr["x_hat"]), np.asarray(jr["x_hat"]), atol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(_nhwc(tr["likelihoods"][k]), np.asarray(jr["likelihoods"][k]),
                                   atol=1e-4)
    np.testing.assert_allclose(float(bpp_from_likelihoods(tr["likelihoods"], 64 * 64)),
                               float(j_bpp(jr["likelihoods"], 64 * 64)), rtol=1e-4)
