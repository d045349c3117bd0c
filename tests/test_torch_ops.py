"""Port vs JAX: the gated bounds and the quantization modes
(``imagecompression_adversarial_tpu_torch/ops``), on the CPU.

Inputs come from numpy; both sides run float32, and every comparison is
exact or at float32 rounding (atol 1e-7) because the ops are elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu import ops as jops
from imagecompression_adversarial_tpu_torch import ops


def _grad(fn, x, w):
    t = torch.tensor(x, requires_grad=True)
    (fn(t) * torch.tensor(w)).sum().backward()
    return t.grad.numpy()


@pytest.mark.parametrize(
    "name, bound, x, w",
    [
        # the cases of tests/test_ops.py: below/above the bound, both signs
        ("lower", 0.0, [-1.0, -1.0, 2.0, 2.0], [1.0, -1.0, 1.0, -1.0]),
        ("upper", 1.0, [2.0, 2.0, -1.0, -1.0], [1.0, -1.0, 1.0, -1.0]),
        # exactly on the bound: the gradient passes
        ("lower", 0.5, [0.5, 0.5], [1.0, -1.0]),
        ("upper", 0.5, [0.5, 0.5], [1.0, -1.0]),
    ],
)
def test_gated_bound_gradients_match_jax(name, bound, x, w):
    x = np.asarray(x, np.float32)
    w = np.asarray(w, np.float32)
    jfn = getattr(jops, f"{name}_bound")
    tfn = getattr(ops, f"{name}_bound")
    jg = jax.grad(lambda v: jnp.sum(w * jfn(v, bound)))(jnp.asarray(x))
    np.testing.assert_array_equal(_grad(lambda t: tfn(t, bound), x, w), np.asarray(jg))
    np.testing.assert_array_equal(
        tfn(torch.tensor(x), bound).numpy(), np.asarray(jfn(jnp.asarray(x), bound))
    )


def test_bound_clip_and_ste_round_match_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-2, 2, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(w * jops.bound_clip(v, 0.0, 1.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(_grad(lambda t: ops.bound_clip(t, 0.0, 1.0), x, w), np.asarray(jg))
    np.testing.assert_array_equal(ops.bound_clip(torch.tensor(x), 0.0, 1.0).numpy(), np.clip(x, 0, 1))
    np.testing.assert_array_equal(_grad(ops.ste_round, x, w), w)
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(
        ops.ste_round(torch.tensor(halves)).numpy(), np.asarray(jops.ste_round(jnp.asarray(halves)))
    )


@pytest.mark.parametrize("mode", ["none", "dequantize", "ste", "noise", "universal"])
@pytest.mark.parametrize("with_means", [False, True])
def test_quantize_modes_match_jax(mode, with_means):
    rng = np.random.RandomState(1)
    # include exact halves: torch.round and jnp.round both round half to even
    y = np.concatenate([rng.uniform(-4, 4, 60), [0.5, 1.5, -0.5, 2.5]]).astype(np.float32)
    means = rng.uniform(-0.5, 0.5, y.shape).astype(np.float32) if with_means else None
    gen = torch.Generator().manual_seed(0)
    t = torch.tensor(y, requires_grad=True)
    out = ops.quantize(t, mode, means=None if means is None else torch.tensor(means), generator=gen)
    if mode in ("noise", "universal"):
        # the random draws differ by framework: check the contract instead
        limit = 0.5 if mode == "noise" else 1.0
        assert np.abs(out.detach().numpy() - y).max() <= limit + 1e-6
        out.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(y))
        with pytest.raises(ValueError):
            ops.quantize(t, mode)  # no generator
        return
    ref = jops.quantize(jnp.asarray(y), mode, means=None if means is None else jnp.asarray(means))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-7, rtol=0)
    if mode == "ste":
        out.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(y))


def test_quantize_rejects_unknown_mode():
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(3), "bogus")
