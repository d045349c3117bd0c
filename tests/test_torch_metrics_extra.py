"""The port's extra metrics and helpers against the JAX package's on the
CPU: ``metrics/fid.py`` (FID, KID, IS and the conv features),
``metrics/lpips.py::alex_feature_fn_from_params``, ``metrics/compare.py``,
``rgb2yuv444``/``mse_yuv444`` and ``utils/introspect.py``; hyper q1 demo
weights at 64x64, one torch thread.

Bounds, each with its reason:
* FID, KID and IS on the same numpy features: equal, the same numpy and
  scipy code on both sides.
* the conv features with the same HWIO kernels (JAX's own, drawn from
  ``jax.random`` as its ``make_conv_feature_fn`` draws them) and the alex
  features with the same weights: within FEAT_RTOL = 1e-5 relative and
  FEAT_ATOL = 1e-6 (float32 convolutions summed in another order); at an
  odd size too, where flax's "SAME" padding puts a zero row on each side.
* ``compare_pair``: PSNR within DB_ATOL = 1e-4 dB and MS-SSIM within
  MSIM_ATOL = 1e-6 (one float32 mean, a pyramid of float32 blurs), and
  MS-SSIM in dB within MSIM_ATOL carried through -10 log10(1 - msim)
  (x 4.3 / (1 - msim), 3.4e-3 dB at these images' msim of 0.9987);
  ``rgb2yuv444`` within 1e-6 and ``mse_yuv444`` within 1e-6 relative.
* ``layer_compare``: every row JAX reports is among the port's, by path;
  each row's mean error and relative error within LAYER_RTOL = 1e-3
  relative plus LAYER_ATOL = 1e-6: the two inputs' activations differ by
  ~1e-2 and each side's float32 activations by ~1e-6 from the other's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imagecompression_adversarial_tpu.metrics import fid as j_fid
from imagecompression_adversarial_tpu.metrics import mse_yuv444 as j_mse_yuv444
from imagecompression_adversarial_tpu.metrics import rgb2yuv444 as j_rgb2yuv444
from imagecompression_adversarial_tpu.metrics.compare import compare_pair as j_compare_pair
from imagecompression_adversarial_tpu.metrics.lpips import LPIPS as JLPIPS
from imagecompression_adversarial_tpu.metrics.lpips import (
    alex_feature_fn_from_params as j_alex_feature_fn,
)
from imagecompression_adversarial_tpu.utils import introspect as j_introspect
from imagecompression_adversarial_tpu_torch.metrics import fid, mse_yuv444, rgb2yuv444
from imagecompression_adversarial_tpu_torch.metrics.compare import compare_pair
from imagecompression_adversarial_tpu_torch.metrics.lpips import (
    alex_feature_fn_from_params, lpips_params_from_jax,
)
from imagecompression_adversarial_tpu_torch.utils import introspect
from torch_parity import hyper_models, image, nchw, nhwc, one_torch_thread  # noqa: F401

FEAT_RTOL, FEAT_ATOL = 1e-5, 1e-6
DB_ATOL = 1e-4
MSIM_ATOL = 1e-6
LAYER_RTOL, LAYER_ATOL = 1e-3, 1e-6


def jax_conv_kernels(dim: int = 64, seed: int = 0):
    """The HWIO kernels of the JAX package's ``make_conv_feature_fn``."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    kernels, in_ch = [], 3
    for k, w in zip(keys, [16, 32, dim]):
        kernels.append(np.asarray(jax.random.normal(k, (3, 3, in_ch, w)) / np.sqrt(9 * in_ch)))
        in_ch = w
    return kernels


def test_distribution_metrics_equal_jax_on_the_same_features():
    rng = np.random.RandomState(3)
    a = rng.randn(40, 8).astype(np.float32)
    b = (rng.randn(30, 8) * 1.3 + 0.4).astype(np.float32)
    assert fid.frechet_distance(a, b) == j_fid.frechet_distance(a, b)
    # rank-deficient covariances (4 samples, 8 features): the eps * I path
    assert fid.frechet_distance(a[:4], b[:5]) == j_fid.frechet_distance(a[:4], b[:5])
    assert fid.kid(a, b, n_subsets=5, subset_size=20) == j_fid.kid(a, b, n_subsets=5,
                                                                   subset_size=20)
    assert fid.kid(a, b, n_subsets=3, subset_size=10, degree=2, gamma=0.5, coef0=0.0) == \
        j_fid.kid(a, b, n_subsets=3, subset_size=10, degree=2, gamma=0.5, coef0=0.0)
    probs = np.exp(a) / np.exp(a).sum(1, keepdims=True)
    assert fid.inception_score(probs, n_splits=4) == j_fid.inception_score(probs, n_splits=4)
    with pytest.raises(ValueError):
        fid.frechet_distance(a[:1], b)


@pytest.mark.parametrize("hw", [(64, 64), (37, 53)])
def test_conv_features_match_jax_with_its_kernels(hw):
    x = np.concatenate([image(s, *hw) for s in (30, 31)])
    want = j_fid.make_conv_feature_fn(dim=24, seed=2)(x)
    got = fid.conv_feature_fn_from_kernels(jax_conv_kernels(24, 2), device="cpu")(x)
    assert got.shape == want.shape == (2, 24)
    np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=FEAT_ATOL)
    ours = fid.make_conv_feature_fn(dim=24, seed=2, device="cpu")(x)
    assert ours.shape == (2, 24) and np.all(np.isfinite(ours))
    np.testing.assert_array_equal(ours, fid.make_conv_feature_fn(24, 2, "cpu")(x))  # seeded


@pytest.mark.parametrize("layer", [-1, 0])
def test_alex_features_match_jax_with_the_same_weights(layer):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = JLPIPS().init(jax.random.PRNGKey(4), x, x)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    state = lpips_params_from_jax(params)
    imgs = np.concatenate([image(s) for s in (32, 33)])
    want = j_alex_feature_fn(params, layer=layer)(imgs)
    for given in (state, {k[len("features."):]: v for k, v in state.items()
                          if k.startswith("features.")}):  # full state, bare trunk
        got = alex_feature_fn_from_params(given, layer=layer, device="cpu")(imgs)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=FEAT_RTOL, atol=FEAT_ATOL)


def test_compare_pair_and_yuv_match_jax():
    a = image(34)
    b = np.clip(a + 0.05 * (image(35) - 0.5), 0, 1).astype(np.float32)
    want, got = j_compare_pair(a, b), compare_pair(a, b, device="cpu")
    assert abs(got["psnr"] - want["psnr"]) <= DB_ATOL
    assert abs(got["msim"] - want["msim"]) <= MSIM_ATOL
    # msim_dB = -10 log10(1 - msim) carries MS-SSIM's bound up by 10 / ln 10 / (1 - msim)
    assert abs(got["msim_dB"] - want["msim_dB"]) <= 10 / np.log(10) * MSIM_ATOL / (1 - want["msim"])
    assert compare_pair(a, a, device="cpu")["msim_dB"] == np.inf
    np.testing.assert_allclose(nhwc(rgb2yuv444(nchw(a))), np.asarray(j_rgb2yuv444(jnp.asarray(a))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(mse_yuv444(nchw(a), nchw(b))),
                               float(j_mse_yuv444(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(float(mse_yuv444(nchw(a), nchw(b), weights=(1, 2, 3))),
                               float(j_mse_yuv444(jnp.asarray(a), jnp.asarray(b), (1, 2, 3))),
                               rtol=1e-6)


@pytest.mark.parametrize("g_a_only", [False, True])
def test_layer_compare_rows_match_jax(g_a_only):
    jm, jp, model = hyper_models()
    xa = image(36)
    xb = np.clip(xa + 0.02 * (image(37) - 0.5), 0, 1).astype(np.float32)
    want = j_introspect.layer_compare(jm, jp, jnp.asarray(xa), jnp.asarray(xb),
                                      method=jm.g_a if g_a_only else None)
    got = {p: (e, r) for p, e, r in introspect.layer_compare(
        model, nchw(xa), nchw(xb), method=model.g_a if g_a_only else None)}
    assert len(want) == (7 if g_a_only else 29)
    for path, err, rel in want:
        assert path in got, path
        for a, b in zip(got[path], (err, rel)):
            assert abs(a - b) <= LAYER_RTOL * abs(b) + LAYER_ATOL, (path, a, b)
    # the same rows moved (z_hat, for one, rounds to the same integers for both inputs)
    assert [got[p][0] > 0 for p, _, _ in want] == [e > 0 for _, e, _ in want]
    y = model.g_a(nchw(xa))
    np.testing.assert_allclose(introspect.channel_maxima(y),
                               j_introspect.channel_maxima(jm.apply({"params": jp}, jnp.asarray(xa),
                                                                    method=jm.g_a)),
                               rtol=0, atol=1e-5)
