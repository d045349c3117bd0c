"""The port's entropy models and bpp vs JAX
(``entropy/factorized.py``, ``entropy/gaussian.py``, ``metrics/core.py``),
on the CPU.

The factorized model uses the trained bottleneck of the committed hyper q1
demo checkpoint.  Tolerances: likelihoods atol 1e-6 (float32 logistic and
erfc chains; values in (0, 1]), bpp rtol 1e-5 (a float32 sum of logs).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.entropy.factorized import EntropyBottleneck as JEB
from imagecompression_adversarial_tpu.entropy.gaussian import (
    gaussian_conditional as j_gc,
    gaussian_likelihood as j_gl,
)
from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu_torch.entropy import (
    EntropyBottleneck,
    gaussian_conditional,
    gaussian_likelihood,
)
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods

CKPT = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack")


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def eb_params():
    with open(CKPT, "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    return {k: np.asarray(v, np.float32) for k, v in tree["entropy_bottleneck"].items()}


@pytest.mark.parametrize("mode", ["dequantize", "none", "ste"])
def test_entropy_bottleneck_matches_jax(eb_params, mode):
    c = eb_params["quantiles"].shape[0]
    z = (np.random.RandomState(0).randn(1, 4, 6, c) * 3).astype(np.float32)
    jz, jlik = JEB(c).apply({"params": eb_params}, z, quant_mode=mode)
    eb = EntropyBottleneck(c)
    state = {}
    for k, v in eb_params.items():
        name = k if k == "quantiles" else "_" + k.replace("_", "")
        state[name] = torch.tensor(v)
    eb.load_state_dict(state)
    tz, tlik = eb(_nchw(z), quant_mode=mode)
    np.testing.assert_allclose(_nhwc(tz), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(_nhwc(tlik), np.asarray(jlik), atol=1e-6)
    assert tlik.min().item() >= 1e-9


@pytest.mark.parametrize("with_means", [False, True])
def test_gaussian_likelihood_and_clamp_gradient_match_jax(with_means):
    rng = np.random.RandomState(1)
    values = np.round(rng.randn(2, 5, 5, 4) * 4).astype(np.float32)
    # scales below 0.11 and above 256 exercise both gated clamps
    scales = np.exp(rng.uniform(np.log(0.01), np.log(600.0), values.shape)).astype(np.float32)
    means = rng.randn(*values.shape).astype(np.float32) if with_means else None
    w = rng.randn(*values.shape).astype(np.float32)
    jm = None if means is None else jnp.asarray(means)
    jlik = j_gl(jnp.asarray(values), jnp.asarray(scales), jm)
    jgs = jax.grad(lambda s: jnp.sum(w * j_gl(jnp.asarray(values), s, jm)))(jnp.asarray(scales))
    st = torch.tensor(scales, requires_grad=True)
    tlik = gaussian_likelihood(torch.tensor(values), st, None if means is None else torch.tensor(means))
    (tlik * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tlik.detach().numpy(), np.asarray(jlik), atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jgs), atol=1e-6, rtol=1e-5)


def test_gaussian_conditional_and_bpp_match_jax():
    rng = np.random.RandomState(2)
    y = (rng.randn(1, 4, 4, 8) * 5).astype(np.float32)
    scales = rng.uniform(0.05, 10.0, y.shape).astype(np.float32)
    jy, jlik = j_gc(jnp.asarray(y), jnp.asarray(scales), quant_mode="dequantize")
    ty, tlik = gaussian_conditional(torch.tensor(y), torch.tensor(scales), quant_mode="dequantize")
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tlik.numpy(), np.asarray(jlik), atol=1e-6)
    z_lik = rng.uniform(1e-3, 1.0, (1, 2, 2, 8)).astype(np.float32)
    jb = float(j_bpp({"y": jlik, "z": jnp.asarray(z_lik)}, 64 * 64))
    tb = float(bpp_from_likelihoods({"y": tlik, "z": torch.tensor(z_lik)}, 64 * 64))
    np.testing.assert_allclose(tb, jb, rtol=1e-5)
