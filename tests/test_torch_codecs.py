"""The port's slice-2 codec families and layers vs JAX
(``models/layers.py``, ``models/codecs.py``, ``models/registry.py``,
``io/weights.py`` and the ``-q 0`` sweep of ``cli/attack_rd.py``), on the CPU.

Each side is built from the same parameters: JAX ``init_params`` (or a layer's
``init``), handed to the port through ``params_from_jax`` with a strict load.
Inputs are numpy arrays made from a seed.  Tolerances:

* layers: atol 1e-5 (float32 convolutions whose sums run in another order);
  ``pixel_shuffle(SubpelConv(x, phase_output=True)) == SubpelConv(x)`` exact.
* family forwards at 64x64, q1, in ``dequantize`` and ``none``: x_hat within
  1e-4 of the output's largest magnitude (seeded random weights drive
  cheng2020-attn's output to ~700, where float32 sums over ~65 convs in
  sequence differ by up to 1.8e-3, 2.6e-6 of it), every likelihood atol 1e-4,
  bpp rtol 1e-4.
* ``g_s_phase`` against ``g_s``: within 1e-5 of the output's largest
  magnitude (the two run the same convs, except the final upsampling).
"""

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F

from imagecompression_adversarial_tpu.metrics import bpp_from_likelihoods as j_bpp
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.models import init_params as j_init_params
from imagecompression_adversarial_tpu.models import layers as jl
from imagecompression_adversarial_tpu.models import registry as j_registry
from imagecompression_adversarial_tpu_torch.cli import attack_rd
from imagecompression_adversarial_tpu_torch.io.weights import load_checkpoint, params_from_jax
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import (
    ARCHITECTURES,
    depth_to_space,
    init_model,
    layers,
    model_dims,
    quality_range,
)

LAYER_ATOL = 1e-5
FAMILIES = ("factorized", "hyper", "context", "cheng2020", "cheng2020-attn", "cheng2020-gmm", "debug")
# the adapter families: tests/test_torch_adapters.py, test_torch_invcompress.py, test_torch_fic.py
ADAPTERS = ("invcompress", "hific", "tic", "nlaic", "fic")
# hyper's forward is compared on its demo weights in test_torch_weights.py
NEW_FAMILIES = tuple(f for f in FAMILIES if f != "hyper")


def _nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# --- layers --------------------------------------------------------------


def _jax_layer_params(jlayer, x, seed, *args):
    """The layer's JAX init, every leaf moved off its init by seeded noise
    (so GDN's gamma is not diagonal and biases are not uniform)."""
    params = _np_tree(jlayer.init(jax.random.PRNGKey(seed), x, *args)["params"])
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.randn(*a.shape)).astype(np.float32), params
    )


def _load_layer(layer, params, deconv=False):
    """Load flax ``params`` of one layer into ``layer`` through the model
    mapping: the layer stands in for ``g_s_0`` of debug (a transposed conv)
    or ``g_a_0`` of any family."""
    top, arch, prefix = ("g_s_0", "debug", "g_s.0.") if deconv else ("g_a_0", "hyper", "g_a.0.")
    state = params_from_jax({top: params}, arch)
    layer.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    return layer.requires_grad_(False)


# (name, JAX layer, port layer, input channels)
_LAYERS = [
    ("masked_conv", lambda: jl.MaskedConv(10), lambda: layers.MaskedConv(6, 10), 6),
    ("subpel_conv", lambda: jl.SubpelConv(5), lambda: layers.SubpelConv(6, 5), 6),
    ("residual_block", lambda: jl.ResidualBlock(6), lambda: layers.ResidualBlock(6), 6),
    ("residual_block_stride", lambda: jl.ResidualBlockWithStride(8),
     lambda: layers.ResidualBlockWithStride(6, 8), 6),
    ("residual_unit", lambda: jl.ResidualUnit(8), lambda: layers.ResidualUnit(8), 8),
    ("attention_block", lambda: jl.AttentionBlock(8), lambda: layers.AttentionBlock(8), 8),
    ("residual_block_upsample", lambda: jl.ResidualBlockUpsample(8),
     lambda: layers.ResidualBlockUpsample(6, 8), 6),
    ("linear_gdn", lambda: jl.LinearGDN(), lambda: layers.LinearGDN(6), 6),
    ("linear_igdn", lambda: jl.LinearGDN(inverse=True), lambda: layers.LinearGDN(6, inverse=True), 6),
]


@pytest.mark.parametrize("name, jlayer, layer, cin", _LAYERS, ids=[c[0] for c in _LAYERS])
def test_layer_matches_jax(name, jlayer, layer, cin):
    x = np.random.RandomState(0).randn(1, 12, 10, cin).astype(np.float32)
    jmod = jlayer()
    params = _jax_layer_params(jmod, x, 1)
    ref = np.asarray(jmod.apply({"params": params}, x))
    got = _load_layer(layer(), params)(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), ref, atol=LAYER_ATOL)


def test_subpel_phase_form_matches_jax_and_shuffles_exactly():
    x = np.random.RandomState(2).randn(1, 7, 9, 6).astype(np.float32)
    jmod = jl.SubpelConv(3)
    params = _jax_layer_params(jmod, x, 3)
    sub = _load_layer(layers.SubpelConv(6, 3), params)
    phase = sub(_nchw(x), phase_output=True)
    ref = np.asarray(jmod.apply({"params": params}, x, phase_output=True))  # NCHW
    assert phase.shape == (1, 12, 7, 9)
    np.testing.assert_allclose(phase.numpy(), ref, atol=LAYER_ATOL)
    np.testing.assert_array_equal(F.pixel_shuffle(phase, 2).numpy(), sub(_nchw(x)).numpy())


def test_stride1_deconv_matches_jax_and_has_no_phase_form():
    x = np.random.RandomState(4).randn(1, 9, 8, 6).astype(np.float32)
    jmod = jl.Deconv(3, kernel_size=3, stride=1)
    params = _jax_layer_params(jmod, x, 5)
    deconv = _load_layer(layers.Deconv(6, 3, 3, 1), params, deconv=True)
    out = deconv(_nchw(x))
    assert out.shape == (1, 3, 9, 8)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jmod.apply({"params": params}, x)),
                               atol=LAYER_ATOL)
    with pytest.raises(ValueError, match="phase_output requires kernel_size=5/stride=2"):
        deconv(_nchw(x), phase_output=True)


def test_masked_conv_sees_only_causal_taps():
    conv = layers.MaskedConv(4, 6).requires_grad_(False)
    torch.nn.init.uniform_(conv.weight, 0.5, 1.0)  # every tap counts
    x = torch.randn(1, 4, 9, 9, generator=torch.Generator().manual_seed(6))
    h, w = 4, 4
    later = x.clone()
    later[:, :, h, w:] += 10.0  # the centre and everything after it in raster order
    later[:, :, h + 1:] += 10.0
    np.testing.assert_array_equal(conv(x)[..., h, w].numpy(), conv(later)[..., h, w].numpy())
    earlier = x.clone()
    earlier[:, :, h, w - 1] += 10.0
    assert (conv(x)[..., h, w] - conv(earlier)[..., h, w]).abs().min() > 1.0
    assert "mask" not in conv.state_dict()  # CompressAI's mask entry is not loaded


# --- families --------------------------------------------------------------

_MODELS = {}


def _family(fam, quality=1):
    """(JAX module, numpy params, port model on the same params)."""
    if (fam, quality) not in _MODELS:
        jm = j_init_model(fam, quality)
        jp = _np_tree(j_init_params(jm, jax.random.PRNGKey(0)))
        model = init_model(fam, quality)
        model.load_state_dict(params_from_jax(jp, fam), strict=True)
        _MODELS[fam, quality] = (jm, jp, model.requires_grad_(False))
    return _MODELS[fam, quality]


@pytest.mark.parametrize("mode", ["dequantize", "none"])
@pytest.mark.parametrize("fam", NEW_FAMILIES)
def test_family_forward_matches_jax(fam, mode):
    jm, jp, model = _family(fam)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    jr = jm.apply({"params": jp}, x, quant_mode=mode)
    tr = model(_nchw(x), quant_mode=mode)
    ref = np.asarray(jr["x_hat"])
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_nhwc(tr["x_hat"]), ref, atol=1e-4 * scale, rtol=0)
    assert tr["likelihoods"].keys() == jr["likelihoods"].keys()
    for k, lik in tr["likelihoods"].items():
        np.testing.assert_allclose(_nhwc(lik), np.asarray(jr["likelihoods"][k]), atol=1e-4)
    np.testing.assert_allclose(float(bpp_from_likelihoods(tr["likelihoods"], 64 * 64)),
                               float(j_bpp(jr["likelihoods"], 64 * 64)), rtol=1e-4)


@pytest.mark.parametrize("fam", ["factorized", "context", "cheng2020", "cheng2020-attn",
                                 "cheng2020-gmm"])
def test_g_s_phase_is_g_s_and_matches_jax(fam):
    jm, jp, model = _family(fam)
    assert model.supports_phase_synthesis
    y = np.random.RandomState(7).randn(1, 3, 4, model.M).astype(np.float32)
    full, phase = model.g_s(_nchw(y)), model.g_s_phase(_nchw(y))
    assert phase.shape == (1, 12, 24, 32)
    # a final Deconv's phase channels are phase-major, a SubpelConv's in
    # pixel_shuffle's order
    upsample = F.pixel_shuffle if fam.startswith("cheng2020") else depth_to_space
    scale = max(1.0, float(full.abs().max()))
    np.testing.assert_allclose(upsample(phase, 2).numpy(), full.numpy(), atol=LAYER_ATOL * scale)
    ref = np.asarray(jm.apply({"params": jp}, y, method=jm.g_s_phase))  # NCHW
    np.testing.assert_allclose(phase.numpy(), ref, atol=1e-4 * scale)


def test_debug_codec_decodes_the_unquantized_latent():
    _, _, model = _family("debug")
    assert not model.supports_phase_synthesis
    x = _nchw(np.random.RandomState(8).rand(1, 16, 16, 3).astype(np.float32))
    res = model(x, quant_mode="dequantize")
    np.testing.assert_array_equal(res["x_hat"].numpy(), model.g_s(res["y"]).numpy())
    assert not torch.equal(res["y"], res["y_hat"])
    with pytest.raises(ValueError, match="phase_output"):
        model.g_s_phase(res["y"])


# --- registry, weights, CLI ----------------------------------------------------


def test_registry_has_the_seven_families():
    """The seven families of ``models/codecs.py`` and, since slice 6, the
    five adapter families: all twelve of the JAX registry, with its widths
    and quality ranges."""
    assert ARCHITECTURES == j_registry.ARCHITECTURES
    assert set(ARCHITECTURES) == set(FAMILIES + ADAPTERS)
    assert quality_range("cheng2020") == quality_range("cheng2020-gmm") == (1, 6)
    assert quality_range("hyper") == quality_range("context") == quality_range("debug") == (1, 8)
    assert model_dims("context", 1) == (192, 192) and model_dims("context", 5) == (192, 320)
    assert model_dims("cheng2020-attn", 3) == (128, 128) and model_dims("cheng2020", 4) == (192, 192)
    assert model_dims("debug", 7) == (3, 192)
    for fam in ARCHITECTURES:
        lo, hi = quality_range(fam)
        assert (lo, hi) == j_registry.quality_range(fam)
        for q in range(lo, hi + 1):
            assert model_dims(fam, q) == j_registry.model_dims(fam, q), (fam, q)
    assert model_dims("invcompress", 1) == (192, 768) and model_dims("hific", 8) == (220, 220)
    assert model_dims("tic", 3) == (128, 192) and model_dims("fic", 6) == (192, 192)
    assert model_dims("nlaic", 4) == (192, 192) and model_dims("nlaic", 5) == (192, 320)
    for bad in (("cheng2020", 7), ("hyper", 9), ("factorized", 0), ("nlaic", 9)):
        with pytest.raises(ValueError, match="out of range"):
            model_dims(*bad)
    with pytest.raises(ValueError, match="not in"):
        model_dims("nope", 1)
    with pytest.raises(ValueError, match="not in"):
        quality_range("nope")
    head = init_model("cheng2020-gmm", 3).entropy_parameters[-1]
    assert (head.in_channels, head.out_channels) == (341, 9 * 128)


@pytest.mark.parametrize("fam, qualities", [("cheng2020", range(1, 7)), ("hyper", range(1, 9))])
def test_quality_sweep_follows_quality_range(monkeypatch, fam, qualities):
    seen = []
    monkeypatch.setattr(attack_rd, "run", lambda cfg: seen.append((cfg.model, cfg.quality)))
    attack_rd.main(["-m", fam, "-q", "0", "-device", "cpu", "--new"])
    assert seen == [(fam, q) for q in qualities]


def test_context_loads_a_compressai_checkpoint_strictly(tmp_path):
    _, jp, model = _family("context")
    state = params_from_jax(jp, "context")
    ckpt = {"net." + k: v for k, v in state.items()}
    ckpt["net.context_prediction.mask"] = torch.ones(384, 192, 5, 5)
    ckpt["net.gaussian_conditional.scale_table"] = torch.zeros(3)
    path = tmp_path / "mbt2018.pth.tar"
    torch.save({"state_dict": ckpt}, path)
    loaded = load_checkpoint(str(path), "context")
    model.load_state_dict(loaded, strict=True)
    for k in state:
        torch.testing.assert_close(loaded[k], state[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no CompressAI layout"):
        load_checkpoint(str(path), "cheng2020-attn")
