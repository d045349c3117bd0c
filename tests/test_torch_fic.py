"""The port's fic family (``models/fic.py``: ``Context4`` and the codec),
``gaussian_conditional(means_free_round=True)`` and the real coder's
``context4`` path (``entropy/codec.py``) against the JAX package on the CPU.

Weights: the committed fic q3 demo tree on both sides (the port loads it
strictly through ``load_checkpoint``); ``Context4`` alone at M=4, hidden 8
from its JAX init moved by seeded noise.  Tolerances, those of
``tests/test_torch_codecs.py``: the context model atol 1e-5; forwards at
64x64 in ``noise`` (the same numpy noise on both sides), ``dequantize`` and
``ste`` with x_hat within 1e-4 of its largest magnitude, likelihoods atol
1e-4 and bpp rtol 1e-4; a 3-step ``select`` attack from the same initial
noise (fic's zero start is a critical point) with vi 1e-3 dB, bpp rtol
1e-4 and ``im_`` atol 1e-3.  That bound is looser than slice 1's 1e-5: near
its critical point every pixel's gradient is small, and Adam (lr / eps =
1e6) turns float32 gradient error into noise error.  Against a float64 run
of the port (plain GDN), JAX's float32 ``im_`` sat 1.0e-4, 3.0e-4 and
3.0e-4 away after 1, 2 and 3 steps, the port's 6.5e-5, 2.0e-4 and 2.0e-4;
the two were 5.0e-4 apart, their vi 4.6e-5 dB.  The coder's round trip is
exact, and its real_bpp lies within 2% of the JAX coder's on the same
image: the symbols agree, the streams can differ where a scale sits on a
CDF row boundary.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.attacks import rd as j_rd
from imagecompression_adversarial_tpu.entropy.codec import RealCodec as JRealCodec
from imagecompression_adversarial_tpu.entropy.gaussian import gaussian_conditional as j_gc
from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import fic as j_fic
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn, rd
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.entropy.codec import RealCodec
from imagecompression_adversarial_tpu_torch.entropy.gaussian import gaussian_conditional
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.models.fic import Context4, phase_masks
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_parity import (  # noqa: F401  (one_torch_thread, shape_noise: fixtures)
    REPO, image, nchw, nhwc, one_torch_thread, onednn, shape_noise,
)

CKPT = str(REPO / "ckpts" / "demo" / "fic-q3-mse-synthetic.msgpack")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


_MODELS = {}


def models():
    """(JAX module, numpy params, port model) of fic q3 on the demo tree."""
    if not _MODELS:
        with open(CKPT, "rb") as f:
            jp = _np_tree(flax.serialization.msgpack_restore(f.read()))
        _MODELS["fic"] = (j_init_model("fic", 3), jp,
                          load_model(Config(device="cpu", model="fic", quality=3, checkpoint=CKPT)))
    return _MODELS["fic"]


def _context(seed=0):
    """(JAX Context4, its params, the port's) at M=4, hidden 8."""
    jctx = j_fic.Context4(M=4, hidden=8)
    params = _np_tree(jctx.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 4)),
                                jnp.zeros((1, 8, 8, 8)))["params"])
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                                    params)
    ctx = Context4(4, hidden=8)
    state = params_from_jax({"context": params}, "fic")
    ctx.load_state_dict({k[len("context."):]: v for k, v in state.items()}, strict=True)
    return jctx, params, ctx.requires_grad_(False)


def test_phase_masks_tile_the_cell_in_decode_order():
    m = phase_masks(4, 6)
    assert m.shape == (4, 1, 4, 6) and torch.equal(m.sum(0), torch.ones(1, 4, 6))
    for k, (a, b) in enumerate(((0, 0), (1, 1), (0, 1), (1, 0))):
        assert m[k, 0, a, b] == 1 and m[k, 0].sum() == 6


def test_context4_matches_jax():
    jctx, params, ctx = _context()
    rng = np.random.RandomState(1)
    y = np.round(3 * rng.randn(1, 8, 10, 4)).astype(np.float32)
    feats = rng.randn(1, 8, 10, 8).astype(np.float32)
    js, jm = jctx.apply({"params": params}, y, feats)
    s, m = ctx(nchw(y), nchw(feats))
    np.testing.assert_allclose(nhwc(s), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(nhwc(m), np.asarray(jm), atol=1e-5)


def test_context4_is_causal_and_its_first_phase_hyper_only():
    """Phase k's parameters do not depend on phases >= k: a last-phase
    pixel changes nothing, a first-phase pixel changes the later phases
    only, and any latent leaves phase (0, 0) as at a zero latent."""
    _, _, ctx = _context()
    gen = torch.Generator().manual_seed(2)
    y = torch.zeros(1, 4, 8, 8)
    feats = torch.rand(1, 8, 8, 8, generator=gen)
    s0, m0 = ctx(y, feats)
    y_last = y.clone()
    y_last[0, :, 1, 0] = 7.0  # phase (1, 0), decoded last
    s1, m1 = ctx(y_last, feats)
    assert torch.equal(s0, s1) and torch.equal(m0, m1)
    y_first = y.clone()
    y_first[0, :, 0, 0] = 7.0
    s2, _ = ctx(y_first, feats)
    assert torch.equal(s0[..., 0::2, 0::2], s2[..., 0::2, 0::2])
    assert not torch.allclose(s0[..., 1::2, 1::2], s2[..., 1::2, 1::2])
    sa, _ = ctx(torch.randn(1, 4, 8, 8, generator=gen), feats)
    np.testing.assert_allclose(sa[..., 0::2, 0::2].numpy(), s0[..., 0::2, 0::2].numpy(), atol=1e-6)


@pytest.mark.parametrize("mode", ["dequantize", "ste", "none"])
def test_means_free_round_matches_jax(mode):
    rng = np.random.RandomState(3)
    y, scales, means = (rng.randn(1, 4, 4, 6).astype(np.float32) * s for s in (3.0, 1.0, 2.0))
    for free in (False, True):
        jy, jl = j_gc(y, np.abs(scales), means=means, quant_mode=mode, means_free_round=free)
        ty, tl = gaussian_conditional(nchw(y), nchw(np.abs(scales)), means=nchw(means),
                                      quant_mode=mode, means_free_round=free)
        np.testing.assert_allclose(nhwc(ty), np.asarray(jy), atol=1e-6)
        np.testing.assert_allclose(nhwc(tl), np.asarray(jl), atol=1e-6)
    if mode == "dequantize":  # plain round(y), not round(y - means) + means
        np.testing.assert_array_equal(nhwc(ty), np.round(y))


@pytest.mark.parametrize("mode", ["noise", "dequantize", "ste"])
def test_forward_matches_jax(mode, shape_noise):
    jm, jp, model = models()
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
    # fic decodes the un-quantized latent
    assert torch.equal(tr["x_hat"], model.g_s(tr["y"]))


def test_attack_matches_jax_from_the_same_noise(monkeypatch):
    jm, jp, model = models()
    assert model.phase_reference_latent == "y" and model.supports_phase_synthesis
    x = image(1)
    noise0 = np.random.RandomState(6).uniform(-0.01, 0.01, x.shape).astype(np.float32)
    monkeypatch.setattr(j_rd, "init_noise", lambda shape, cfg, key: jnp.asarray(noise0))
    monkeypatch.setattr(rd, "init_noise", lambda shape, cfg, generator, device: nchw(noise0))
    kw = dict(steps=3, two_phase_impl="select")
    jres = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    with onednn(False):
        res = make_attack_fn(model, RDAttackConfig(**kw))(nchw(x))
    np.testing.assert_allclose(nhwc(res["im_"]), np.asarray(jres["im_"]), atol=1e-3, rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4)
    assert res["vi"].item() != 0.0  # moved off the critical point


def test_context4_coder_round_trip_and_rate_match_jax():
    jm, jp, model = models()
    x = image(2)
    codec = RealCodec(model)
    trace = {}
    out = codec.compress(nchw(x), trace)
    y_hat = codec.decode_latent(out["strings"], out["shape"])
    assert torch.equal(y_hat, trace["y_hat"])
    assert torch.equal(y_hat, torch.round(model.g_a(nchw(x))))  # plain round(y) symbols
    jcodec = JRealCodec(jm, jp)
    jout = jcodec.compress(x)
    real, jreal = codec.real_bpp(out, 64 * 64), jcodec.real_bpp(jout, 64 * 64)
    assert abs(real / jreal - 1.0) <= 0.02
    assert abs(out["ideal_bits"] / jout["ideal_bits"] - 1.0) <= 0.02
    x_hat = codec.synthesize(y_hat)
    np.testing.assert_allclose(nhwc(x_hat), np.asarray(jcodec.decompress(jout["strings"],
                                                                         jout["shape"])),
                               atol=1e-4)


def test_demo_tree_loads_strictly():
    model = init_model("fic", 3)
    with open(CKPT, "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    state = models()[2].state_dict()
    model.load_state_dict(state, strict=True)
    assert len(state) == len(jax.tree_util.tree_leaves(tree))
