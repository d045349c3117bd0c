"""The port's forward-only phase loop (``attacks/common.py::
make_phase_fwd_scan``) against JAX's on the CPU: hyper q1 on the demo
weights, a seeded 64x64 image, 5 steps, the port's plain GDN.

The loop's result is the noise ``n``, every element of which is the sum of
the steps' ``1e-6 * mean(g_s_phase(g_a(x + n)))``: both sides' means agree
to float32 rounding of a 12-channel mean (relative 1e-5 here), so ``n`` is
held at rtol 1e-5 and atol 1e-12 (``n`` is ~1e-6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imagecompression_adversarial_tpu.attacks.common import make_phase_fwd_scan as j_scan
from imagecompression_adversarial_tpu_torch.attacks.common import make_phase_fwd_scan
from torch_parity import hyper_models, image, nchw, nhwc, one_torch_thread  # noqa: F401

STEPS = 5
RTOL, ATOL = 1e-5, 1e-12


def test_fwd_scan_equals_jax():
    jm, jp, model = hyper_models()
    x = image(3)
    params = jax.tree_util.tree_map(jnp.asarray, jp)  # scan indexes kernels by traced arrays
    want = np.asarray(j_scan(jm, STEPS)(params, jnp.asarray(x)))
    got = nhwc(make_phase_fwd_scan(model, STEPS)(nchw(x)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fwd_scan_runs_no_grad_and_chains_each_step():
    _, _, model = hyper_models()
    x = nchw(image(4))
    calls = []

    def seen(_module, args):
        calls.append(float(args[0][0, 0, 0, 0]))
        assert not torch.is_grad_enabled()

    hook = model.g_a.register_forward_pre_hook(seen)
    try:
        n = make_phase_fwd_scan(model, 3)(x)
    finally:
        hook.remove()
    assert len(calls) == 3 and not n.requires_grad
    # each step sees the noise the steps before it made
    assert calls[0] == float(x[0, 0, 0, 0]) and len(set(calls)) == 3
    assert torch.equal(n, n.flatten()[0].expand_as(n))
