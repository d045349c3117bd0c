"""The port's defenses (``defenses/self_ensemble.py``, ``defenses/latent.py``)
and the evaluation's defense hook vs the JAX package, on the CPU.

Exact: the dihedral group and its inverse, bit-depth reduction, the resize
draw and the rank-order clip on a latent with tied dead channels.  At atol
1e-5: the bicubic resize (torch's antialiased bicubic is Keys a = -0.5, as
``jax.image.resize``'s cubic) and its input gradient, the clamps and the
anomaly score.  The self-ensemble on hyper q1 (demo weights, 64x64):
``x_hat`` atol 1e-4, bpp rtol 1e-4, the same winner.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu_torch.attacks import evaluate
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, hyper_models, image, jax_apply, nchw, nhwc, one_torch_thread, onednn,
)

# the modules (each package's __init__ re-exports a function named self_ensemble)
j_latent = importlib.import_module("imagecompression_adversarial_tpu.defenses.latent")
j_se = importlib.import_module("imagecompression_adversarial_tpu.defenses.self_ensemble")
latent = importlib.import_module("imagecompression_adversarial_tpu_torch.defenses.latent")
se = importlib.import_module("imagecompression_adversarial_tpu_torch.defenses.self_ensemble")


def _nhwc_group(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_dihedral_group_matches_jax_exactly():
    x = image(0, 8, 12)
    jf, jr = j_se.dihedral_forward(jnp.asarray(x))
    f, r = se.dihedral_forward(nchw(x))
    assert f.shape == (4, 3, 8, 12) and r.shape == (4, 3, 12, 8)
    np.testing.assert_array_equal(_nhwc_group(f), np.asarray(jf))
    np.testing.assert_array_equal(_nhwc_group(r), np.asarray(jr))
    # the inverse of distinct reconstructions, not only of the variants
    rng = np.random.RandomState(1)
    hf, hr = rng.rand(4, 8, 12, 3).astype(np.float32), rng.rand(4, 12, 8, 3).astype(np.float32)
    inv = se.dihedral_inverse_group(torch.tensor(hf).permute(0, 3, 1, 2),
                                    torch.tensor(hr).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_nhwc_group(inv),
                                  np.asarray(j_se.dihedral_inverse_group(hf, hr)))
    # each of the 8 transforms is undone exactly
    for k, v in enumerate(se.dihedral_inverse_group(f, r)):
        np.testing.assert_array_equal(v.numpy(), nchw(x)[0].numpy(), err_msg=str(k))
    with pytest.raises(ValueError, match="single image"):
        se.dihedral_forward(torch.zeros(2, 3, 8, 8))


def test_bitdepth_reduction_matches_jax():
    x = image(2, 16, 16)
    x[0, 0, :6, 0] = np.arange(6) / 126.0  # exact half steps of the 6-bit grid
    np.testing.assert_array_equal(nhwc(se.bitdepth_reduction(nchw(x))),
                                  np.asarray(j_se.bitdepth_reduction(jnp.asarray(x))))
    t = nchw(x).requires_grad_(True)
    (g,) = torch.autograd.grad(se.bitdepth_reduction(t).sum(), t)
    np.testing.assert_array_equal(g.numpy(), np.ones_like(g.numpy()))  # identity gradient
    # the dithered surrogate: (x * 63 + u) / 63 with u drawn from the generator
    u = torch.rand(nchw(x).shape, generator=torch.Generator().manual_seed(3)) - 0.5
    out = se.bitdepth_reduction(nchw(x), inference=False, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(out.numpy(), ((nchw(x) * 63 + u) / 63).numpy(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        se.bitdepth_reduction(nchw(x), inference=False)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_draw_resize_scale_matches_jax(seed):
    assert se.draw_resize_scale(seed) == j_se.draw_resize_scale(seed)


@pytest.mark.parametrize("scale", [243.0 / 256.0, j_se.draw_resize_scale(0)])
def test_random_resize_matches_jax(scale):
    x = image(4, 64, 96)
    jup, _ = j_se.random_resize(jnp.asarray(x), scale)
    t = nchw(x).requires_grad_(True)
    up, s = se.random_resize(t, scale)
    assert s == scale and up.shape == t.shape
    np.testing.assert_allclose(nhwc(up), np.asarray(jup), atol=1e-5, rtol=0)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(j_se.random_resize(v, scale)[0] * w))(jnp.asarray(x))
    (g,) = torch.autograd.grad((up * nchw(w)).sum(), t)
    np.testing.assert_allclose(nhwc(g), np.asarray(jg), atol=1e-5, rtol=0)


def test_clamps_and_anomaly_score_match_jax():
    rng = np.random.RandomState(6)
    y = (3.0 * rng.randn(1, 4, 5, 8)).astype(np.float32)
    cmax, cmin = rng.rand(8).astype(np.float32) + 1.0, -rng.rand(8).astype(np.float32) - 1.0
    np.testing.assert_allclose(nhwc(latent.clamp_value_naive(nchw(y), cmax, cmin)),
                               np.asarray(j_latent.clamp_value_naive(y, cmax, cmin)), atol=1e-5)
    means = rng.randn(*y.shape).astype(np.float32)
    scales = rng.rand(*y.shape).astype(np.float32) * 0.5
    np.testing.assert_allclose(
        nhwc(latent.clamp_feature_with_p(nchw(y), nchw(means), nchw(scales), epsilon=2.0)),
        np.asarray(j_latent.clamp_feature_with_p(y, means, scales, epsilon=2.0)), atol=1e-5)
    np.testing.assert_allclose(latent.anomaly_score(nchw(y), cmax, cmin).item(),
                               float(j_latent.anomaly_score(y, cmax, cmin)), atol=1e-5)


def test_clip_dead_channel_matches_jax_with_tied_dead_channels():
    rng = np.random.RandomState(7)
    c = 12
    y = rng.randn(1, 4, 4, c).astype(np.float32)
    # dead channels tie at abs-max 0.3 (not at 0, where abs has no derivative:
    # JAX takes 1 there, torch 0, which only a latent of exact zeros meets)
    y[..., [1, 4, 9]] = 0.3 * np.sign(rng.randn(1, 4, 4, 3))
    y[..., [2, 6]] = 0.5 * np.sign(y[..., [2, 6]])  # a live tie
    y[0, 0, 0, 3] = 40.0  # far above its profiled rank
    y[0, 1, 1, 10] = -25.0
    dead = np.zeros(c, bool)
    dead[[1, 4, 5, 9]] = True
    ranks_min = np.array([0, 11, 5, 9, 10, 3, 4, 2, 1, 8, 7, 6])
    for tol in (2, 100):
        ref = np.asarray(j_latent.clip_dead_channel(jnp.asarray(y), dead, ranks_min, tolerance=tol))
        t = nchw(y).requires_grad_(True)
        out = latent.clip_dead_channel(t, dead, ranks_min, tolerance=tol)
        np.testing.assert_array_equal(nhwc(out), ref)
        w = rng.randn(*y.shape).astype(np.float32)
        jg = jax.grad(lambda v: jnp.sum(
            j_latent.clip_dead_channel(v, dead, ranks_min, tolerance=tol) * w))(jnp.asarray(y))
        (g,) = torch.autograd.grad((out * nchw(w)).sum(), t)
        np.testing.assert_allclose(nhwc(g), np.asarray(jg), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="single image"):
        latent.clip_dead_channel(torch.zeros(2, c, 2, 2), dead, ranks_min)


def test_load_range_profile_and_profile_path(tmp_path):
    path = tmp_path / "p.npz"
    np.savez(path, channel_max=np.ones(4), channel_min=-np.ones(4))
    prof = latent.load_range_profile(str(path))
    assert set(prof) == {"channel_max", "channel_min"}
    with pytest.raises(ValueError, match="lacks"):
        latent.load_range_profile(str(path), require=("dead", "ranks_min"))
    from imagecompression_adversarial_tpu.analysis.feature_range import profile_path

    assert latent.profile_path("hyper", "mse", 1) == profile_path("hyper", "mse", 1)


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("impl", ["batch", "scan"])
def test_self_ensemble_matches_jax(impl, enabled):
    jm, jp, model = hyper_models()
    x = image(8, 64, 64)
    jout = j_se.self_ensemble(jax_apply(jm, jp), jnp.asarray(x), impl=impl)
    with onednn(enabled), torch.no_grad():
        out = se.self_ensemble(model, nchw(x), impl=impl)
    assert int(out["best_idx"]) == int(jout["best_idx"])
    np.testing.assert_allclose(nhwc(out["x_hat"]), np.asarray(jout["x_hat"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out["bpp"].item(), float(jout["bpp"]), rtol=BPP_RTOL)
    np.testing.assert_allclose(out["best_mse"].item(), float(jout["best_mse"]), rtol=1e-4)


def test_self_ensemble_scan_gradient_matches_batch():
    _, _, model = hyper_models()
    x = nchw(image(9, 64, 64))
    grads = []
    for impl in ("batch", "scan"):
        t = x.clone().requires_grad_(True)
        out = se.self_ensemble(model, t, quant_mode="none", impl=impl)["x_hat"]
        grads.append(torch.autograd.grad(out.sum(), t)[0])
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="impl"):
        se.self_ensemble(model, x, impl="typo")


@pytest.mark.parametrize("method", ["ensemble", "bitdepth", "resize", "clip"])
def test_evaluate_through_defense_matches_jax(method):
    from imagecompression_adversarial_tpu.attacks import evaluate as j_evaluate
    from imagecompression_adversarial_tpu_torch.defenses import make_defend_fn

    jm, jp, model = hyper_models()
    x = image(10, 64, 64)
    adv = np.clip(x + 0.02 * np.random.RandomState(11).randn(*x.shape), 0, 1).astype(np.float32)
    apply_fn = jax_apply(jm, jp)
    output_s = np.clip(np.asarray(apply_fn(x, quant_mode="dequantize")["x_hat"]), 0, 1)
    if method == "clip":
        y = np.asarray(jm.apply({"params": jp}, x, method=jm.g_a))
        dead = np.abs(y).max(axis=(0, 1, 2)) < 2.0
        ranks_min = np.argsort(np.argsort(-np.abs(y).max(axis=(0, 1, 2)), kind="stable"))
        jdef = j_latent.make_latent_defend_fn(jm, jp, lambda v: j_latent.clip_dead_channel(
            v, dead, ranks_min, tolerance=5))
        pdef = latent.make_latent_defend_fn(model, lambda v: latent.clip_dead_channel(
            v, dead, ranks_min, tolerance=5))
    else:
        jdef, pdef = j_se.make_defend_fn(apply_fn, method), make_defend_fn(model, method)
    jres = j_evaluate(apply_fn, adv, x, output_s, defend_fn=jdef)
    res = evaluate(model, nchw(adv), nchw(x), nchw(output_s), defend_fn=pdef)
    np.testing.assert_allclose(nhwc(res["output_"]), np.asarray(jres["output_"]), atol=1e-4)
    np.testing.assert_allclose(res["bpp"].item(), float(jres["bpp"]), rtol=BPP_RTOL)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    if method != "clip":
        with pytest.raises(ValueError):
            make_defend_fn(model, "bogus")
