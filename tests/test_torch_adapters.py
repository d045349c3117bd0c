"""The port's adapter families nlaic, tic and hific (``models/nlaic.py``,
``models/tic.py``, ``models/hific.py``) against the JAX package on the CPU.

Weights: nlaic and tic on their committed q3 demo trees (both sides read
the same msgpack; the port through ``load_checkpoint``, strictly); hific
has no demo tree, so the port's seeded ``init_model`` with every parameter
moved by 0.01 x normal noise goes to JAX (``torch_parity.jax_params_from_port``).
Inputs are numpy arrays made from seeds.  Tolerances, those of
``tests/test_torch_codecs.py``:

* submodules: atol 1e-5 (float32 sums in another order);
* forwards at 64x64 in ``noise`` (the same numpy noise on both sides),
  ``dequantize`` and ``ste``: x_hat within 1e-4 of the output's largest
  magnitude, every likelihood atol 1e-4, bpp rtol 1e-4;
* a 3-step ``select`` RD attack at 64x64 (oneDNN off, one thread): vi
  1e-3 dB, bpp rtol 1e-4, and ``im_`` atol 1e-5 for nlaic (slice 1's
  bound).  tic and hific attack at full resolution (no phase synthesis)
  through layer norms and 960-channel ChannelNorms, and Adam (lr / eps =
  1e6) turns gradient error on near-zero-gradient pixels into noise error;
  against a float64 run of the port after 3 steps, JAX's float32 ``im_``
  sat 5.6e-5 (tic) and 5.4e-5 (hific) away, the port's 4.2e-5 and 2.0e-4,
  so ``im_`` is held at 1e-4 (tic) and 5e-4 (hific, cheng2020-gmm's bound
  in ``tests/test_torch_attack_families.py``);
* the real coder at 64x64: the decoded latent equals the encoder's.

The non-local block runs ``F.scaled_dot_product_attention``; JAX writes the
same softmax product as two einsums, so the submodule parity holds the one
to the other.
"""

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import hific as j_hific
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.models import nlaic as j_nlaic
from imagecompression_adversarial_tpu.models import tic as j_tic
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.entropy.codec import RealCodec
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import (
    depth_to_space, hific, init_model, nlaic, tic,
)
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_parity import (  # noqa: F401  (one_torch_thread, shape_noise: fixtures)
    REPO, image, jax_params_from_port, nchw, nhwc, one_torch_thread, onednn, perturb_, shape_noise,
)

LAYER_ATOL = 1e-5
FAMILIES = ("nlaic", "tic", "hific")
IM_ATOL = {"nlaic": 1e-5, "tic": 1e-4, "hific": 5e-4}  # the attack's im_ (docstring)
DEMO = {f: str(REPO / "ckpts" / "demo" / f"{f}-q3-mse-synthetic.msgpack") for f in ("nlaic", "tic")}

_MODELS = {}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def models(fam):
    """(JAX module, numpy params, port model) of ``fam`` q3 on the same weights."""
    if fam not in _MODELS:
        jm = j_init_model(fam, 3)
        if fam in DEMO:
            with open(DEMO[fam], "rb") as f:
                jp = _np_tree(flax.serialization.msgpack_restore(f.read()))
            model = load_model(Config(device="cpu", model=fam, quality=3, checkpoint=DEMO[fam]))
        else:
            model = perturb_(init_model(fam, 3, seed=5), 0.01).requires_grad_(False)
            jp = jax_params_from_port(model, jm, fam)
        _MODELS[fam] = (jm, jp, model)
    return _MODELS[fam]


# --- submodules ----------------------------------------------------------


def _load_layer(layer, params):
    """Load a layer's flax params through the model mapping (the layer
    stands in for a top-level module of tic, which keeps flax names)."""
    state = params_from_jax({"embed_0": params}, "tic")
    layer.load_state_dict({k[len("embed_0."):]: v for k, v in state.items()}, strict=True)
    return layer.requires_grad_(False)


def _jax_layer(jmod, x, seed):
    params = _np_tree(jmod.init(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
                                  params)


# (name, JAX layer, port layer, input channels, NHWC port layer)
_LAYERS = [
    ("nonlocal_block", lambda: j_nlaic.NonLocalBlock(8), lambda: nlaic.NonLocalBlock(8), 8, False),
    ("nlam", lambda: j_nlaic.NLAM(8), lambda: nlaic.NLAM(8), 8, False),
    ("swin_block", lambda: j_tic.SwinBlock(8, 2, 4, False), lambda: tic.SwinBlock(8, 2, 4, False),
     8, True),
    ("swin_block_shifted", lambda: j_tic.SwinBlock(8, 2, 4, True),
     lambda: tic.SwinBlock(8, 2, 4, True), 8, True),
    ("channel_norm", lambda: j_hific.ChannelNorm(), lambda: hific.ChannelNorm(6), 6, False),
    ("hific_residual_block", lambda: j_hific.HiFiCResidualBlock(6),
     lambda: hific.HiFiCResidualBlock(6), 6, False),
]


@pytest.mark.parametrize("name, jlayer, layer, cin, channels_last", _LAYERS,
                         ids=[c[0] for c in _LAYERS])
def test_submodule_matches_jax(name, jlayer, layer, cin, channels_last):
    x = np.random.RandomState(0).randn(1, 12, 8, cin).astype(np.float32)
    jmod = jlayer()
    params = _jax_layer(jmod, x, 1)
    ref = np.asarray(jmod.apply({"params": params}, x))
    mod = _load_layer(layer(), params)
    got = mod(torch.from_numpy(x)).numpy() if channels_last else nhwc(mod(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=LAYER_ATOL)


def test_window_partition_round_trip_matches_jax():
    x = np.random.RandomState(3).rand(2, 8, 12, 5).astype(np.float32)
    wins = tic.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(j_tic.window_partition(x, 4)))
    np.testing.assert_array_equal(tic.window_merge(wins, 4, 2, 8, 12).numpy(), x)


def test_window_attention_is_local():
    """A change at pixel (1, 1) moves its whole 4x4 window of a plain block
    and nothing outside it; in the shifted block (rolled by -2) it moves the
    window of rows and columns 6, 7, 0, 1 instead."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 8, 8, generator=gen)
    x2 = x.clone()
    x2[0, 1, 1] += torch.randn(8, generator=gen)
    for shift, window in ((False, [0, 1, 2, 3]), (True, [6, 7, 0, 1])):
        blk = perturb_(tic.SwinBlock(8, 2, 4, shift), 0.1)
        moved = (blk(x2) - blk(x)).abs().sum(-1)[0] > 0
        inside = torch.zeros(8, 8, dtype=torch.bool)
        inside[torch.tensor(window)[:, None], torch.tensor(window)[None, :]] = True
        assert torch.equal(moved, inside)


def test_nonlocal_block_is_global():
    blk = perturb_(nlaic.NonLocalBlock(8), 0.1)
    x = torch.rand(1, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    x2 = x.clone()
    x2[0, :, 0, 0] += 3.0
    diff = (blk(x2) - blk(x)).abs().sum(1)[0]
    assert (diff > 0).float().mean() > 0.9  # nearly every position moved


# --- whole codecs ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["noise", "dequantize", "ste"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_forward_matches_jax(fam, mode, shape_noise):
    jm, jp, model = models(fam)
    x = image(0)
    jr = jm.apply({"params": jp}, x, quant_mode=mode, rngs={"quant": jax.random.PRNGKey(0)})
    tr = model(nchw(x), quant_mode=mode, generator=torch.Generator().manual_seed(0))
    ref = np.asarray(jr["x_hat"])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(nhwc(tr["x_hat"]), ref, atol=1e-4 * scale, rtol=0)
    assert tr["likelihoods"].keys() == jr["likelihoods"].keys()
    for k, lik in tr["likelihoods"].items():
        np.testing.assert_allclose(nhwc(lik), np.asarray(jr["likelihoods"][k]), atol=1e-4)
    np.testing.assert_allclose(float(bpp_from_likelihoods(tr["likelihoods"], 64 * 64)),
                               float(j_bpp(jr["likelihoods"], 64 * 64)), rtol=1e-4)
    for key in ("scales_hat", "means_hat"):
        np.testing.assert_allclose(nhwc(tr[key]), np.asarray(jr[key]), atol=1e-4)


def test_nlaic_phase_synthesis_runs_the_nlams():
    jm, jp, model = models("nlaic")
    assert model.supports_phase_synthesis
    names = [n for n, _ in model.g_s.named_children()]
    assert names[:6] == ["nlam_0", "0", "1", "2", "3", "nlam_1"]
    y = np.random.RandomState(7).randn(1, 3, 4, model.M).astype(np.float32)
    full, phase = model.g_s(nchw(y)), model.g_s_phase(nchw(y))
    scale = max(1.0, float(full.abs().max()))
    np.testing.assert_allclose(depth_to_space(phase, 2).numpy(), full.numpy(),
                               atol=LAYER_ATOL * scale)
    ref = np.asarray(jm.apply({"params": jp}, y, method=jm.g_s_phase))  # NCHW
    np.testing.assert_allclose(phase.numpy(), ref, atol=1e-4 * scale)


def test_mean_scale_families_have_no_phase_synthesis():
    for fam in ("tic", "hific"):
        model = models(fam)[2]
        assert model.entropy_structure == "mean_scale" and not model.supports_phase_synthesis


_JAX_ATTACKS = {}


@pytest.mark.parametrize("fam", FAMILIES)
def test_attack_matches_jax(fam):
    jm, jp, model = models(fam)
    x = image(1)
    kw = dict(steps=3, two_phase_impl="select")
    if fam not in _JAX_ATTACKS:
        _JAX_ATTACKS[fam] = j_make_attack_fn(jm, JConfig(**kw))(jp, x)
    jres = _JAX_ATTACKS[fam]
    with onednn(False):
        res = make_attack_fn(model, RDAttackConfig(**kw))(nchw(x))
    im_ = nhwc(res["im_"])
    np.testing.assert_allclose(im_, np.asarray(jres["im_"]), atol=IM_ATOL[fam], rtol=0)
    assert abs(res["vi"].item() - float(jres["vi"])) <= 1e-3
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-4)
    assert np.abs(im_ - x).max() > 1e-3  # the attack moved the input


@pytest.mark.parametrize("fam", FAMILIES)
def test_coder_round_trip(fam):
    model = models(fam)[2]
    codec = RealCodec(model)
    trace = {}
    out = codec.compress(nchw(image(2)), trace)
    y_hat = codec.decode_latent(out["strings"], out["shape"])
    assert torch.equal(y_hat, trace["y_hat"])
    x_hat = codec.synthesize(y_hat)
    assert x_hat.shape == (1, 3, 64, 64) and torch.isfinite(x_hat).all()
    real = codec.real_bpp(out, 64 * 64)
    assert 0 < out["ideal_bits"] / (64 * 64) <= real


@pytest.mark.parametrize("fam", sorted(DEMO))
def test_demo_tree_loads_strictly(fam):
    model = init_model(fam, 3)
    with open(DEMO[fam], "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    state = models(fam)[2].state_dict()
    assert model.load_state_dict(state, strict=True) is not None
    assert len(state) == n_leaves  # every flax leaf has its place, and only those
