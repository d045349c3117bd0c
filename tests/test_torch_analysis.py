"""The port's analysis modules (``analysis/feature_range.py``,
``search.py``, ``distribution.py``, ``transfer.py``) against the JAX
package's on the CPU: hyper q1 demo weights, 64x64 images, one torch
thread.

Bounds, each with its reason:
* the latent profile (``g_a`` over three images): ``channel_max``,
  ``channel_min`` and the per-image max, min and abs-max within PROFILE_ATOL
  = 1e-5 (float32 convolutions summed in another order; measured at most
  6.2e-6 on latents up to 6.3); the ranks and the ``dead`` mask (185 of 192
  channels) equal: the closest two abs-maxima of an image lie 2.2e-6 apart,
  and both packages order them alike on these images; the ``.npz`` each
  package writes loads in the other's ``load_range_profile`` with every
  key.
* the detection scores: the same float32 latents through a max and a
  division, within PROFILE_ATOL; the search order equal.
* ``predicted_distribution`` on the same means and scales: within 1e-6 (the
  same erfc expression, float32); the per-channel rates of two images'
  dequantized forwards within RATE_RTOL = 1e-5 relative (sums of -log2 of
  float32 likelihoods); the top ten of the inflation ranking the same up
  to ties: channels whose inflations lie within RATE_RTOL of each other
  (several channels gain the same few symbols' bits, equal to the last bit
  on one side and not on the other) may come in either order, so each
  place's channel must have the inflation of JAX's channel there; the
  latent histograms equal (``y_hat`` rounds to the same integers).
* transfer: a single forward pair's vi within VI_ATOL (``tests/torch_parity.py``),
  the cross-image and cross-model matrices of 6-step attacks within VI_ATOL
  too, oneDNN off: the attacks' noises agree within ``IM_ATOL[False]``
  (``tests/test_torch_attack_rd.py``), and a vi of pasting a noise moves by
  far less than 1e-3 dB for noise that close.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import torch

import imagecompression_adversarial_tpu.analysis as j_analysis
from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.defenses import load_range_profile as j_load_range_profile
from imagecompression_adversarial_tpu.models import init_model as j_init_model
import imagecompression_adversarial_tpu_torch.analysis as analysis
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
from imagecompression_adversarial_tpu_torch.defenses import load_range_profile
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    CKPT, VI_ATOL, hyper_models, image, jax_params_from_port, nchw, one_torch_thread, onednn,
)

PROFILE_ATOL = 1e-5
RATE_RTOL = 1e-5
PMF_ATOL = 1e-6
STEPS = 6


def assert_same_ranking(got, want, inflation, rtol=RATE_RTOL):
    """``got`` and ``want`` rank channels alike up to ties: at each place,
    the inflations (JAX's) of the two channels there agree within
    ``rtol``."""
    assert len(got) == len(want)
    np.testing.assert_allclose(inflation[np.asarray(got)], inflation[np.asarray(want)], rtol=rtol)


def _g_a(jm, jp):
    return lambda x: jm.apply({"params": jp}, x, method=jm.g_a)


def _profiles(seeds=(80, 81, 82)):
    jm, jp, model = hyper_models()
    imgs = [image(s) for s in seeds]
    want = j_analysis.profile_latents(_g_a(jm, jp), imgs)
    got = analysis.profile_latents(model.g_a, [nchw(im) for im in imgs])
    return want, got


def test_analysis_exports_every_jax_name():
    assert sorted(analysis.__all__) == sorted(j_analysis.__all__)


def test_profile_latents_matches_jax():
    want, got = _profiles()
    assert sorted(got) == sorted(want)
    for key in ("channel_max", "channel_min", "per_image_max", "per_image_min",
                "per_image_absmax"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=PROFILE_ATOL, err_msg=key)
    for key in ("ranks_max", "ranks_min", "dead"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["dead"].any() and not got["dead"].all()  # the mask is exercised
    np.testing.assert_array_equal(analysis.dead_channels(got), j_analysis.dead_channels(want))


def test_profile_npz_loads_across_packages(tmp_path):
    want, got = _profiles()
    assert analysis.profile_path("hyper", "mse", 1, adv=True, root=str(tmp_path)) == \
        j_analysis.profile_path("hyper", "mse", 1, adv=True, root=str(tmp_path))
    port_file, jax_file = str(tmp_path / "port" / "p.npz"), str(tmp_path / "jax" / "p.npz")
    analysis.save_profile(got, port_file)
    j_analysis.save_profile(want, jax_file)
    require = ("dead", "ranks_min")
    for loaded, src in ((j_load_range_profile(port_file, require=require), got),
                        (load_range_profile(jax_file, require=require), want)):
        for key in ("channel_max", "channel_min", "dead", "ranks_min", "ranks_max"):
            np.testing.assert_array_equal(loaded[key], src[key], err_msg=key)
    assert sorted(np.load(port_file).files) == sorted(np.load(jax_file).files)


def test_detect_scores_and_search_order_match_jax():
    jm, jp, model = hyper_models()
    prof, _ = _profiles()
    j_detect = j_analysis.make_detect_fn(_g_a(jm, jp), prof["channel_max"], prof["channel_min"])
    detect = analysis.make_detect_fn(model.g_a, prof["channel_max"], prof["channel_min"])
    # images unlike the profiled ones (and one of them), so most scores are > 0
    imgs = {f"im{s}": image(s, 64, 64) * (0.5 + 0.25 * i) for i, s in enumerate((83, 84, 80))}
    want = j_analysis.search_corpus(j_detect, imgs.items())
    got = analysis.search_corpus(detect, [(k, nchw(v)) for k, v in imgs.items()])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= PROFILE_ATOL, (a, b)
    assert max(s for _, s in got) > 0.0


def test_predicted_distribution_and_rate_ranking_match_jax():
    rng = np.random.RandomState(5)
    means = rng.uniform(-5, 5, (2, 3, 4, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 20, (2, 3, 4, 4)).astype(np.float32)
    want = np.asarray(j_analysis.predicted_distribution(jnp.asarray(means), jnp.asarray(scales)))
    got = analysis.predicted_distribution(torch.from_numpy(means), torch.from_numpy(scales))
    assert got.shape == want.shape == (61, 2, 3, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PMF_ATOL)

    jm, jp, model = hyper_models()
    x_nat, x_adv = image(85), np.clip(image(85) + 0.2 * image(86) - 0.1, 0, 1)
    j_res = [jm.apply({"params": jp}, jnp.asarray(x), quant_mode="dequantize")
             for x in (x_nat, x_adv)]
    with torch.no_grad():
        res = [model(nchw(x), quant_mode="dequantize") for x in (x_nat, x_adv)]
    want = j_analysis.rate_inflation_ranking(j_res[0]["likelihoods"]["y"],
                                             j_res[1]["likelihoods"]["y"])
    got = analysis.rate_inflation_ranking(res[0]["likelihoods"]["y"], res[1]["likelihoods"]["y"])
    for key in ("rate_natural", "rate_adversarial"):
        np.testing.assert_allclose(got[key], want[key], rtol=RATE_RTOL, err_msg=key)
    assert_same_ranking(got["ranking"][:10], want["ranking"][:10], want["inflation"])
    channel = int(got["ranking"][0])
    for g, w in zip(analysis.latent_histogram(res[0]["y_hat"], channel),
                    j_analysis.latent_histogram(j_res[0]["y_hat"], channel)):
        np.testing.assert_array_equal(g, w)


def test_transfer_eval_fn_matches_jax():
    jm, jp, model = hyper_models()
    x, noise = image(87), 0.02 * (image(88) - 0.5)
    want = float(j_analysis.make_transfer_eval_fn(jm)(jp, jnp.asarray(x), jnp.asarray(noise)))
    got = float(analysis.make_transfer_eval_fn(model)(nchw(x), nchw(noise)))
    assert np.isfinite(got) and abs(got - want) <= VI_ATOL, (got, want)


def test_cross_image_matrix_matches_jax():
    jm, jp, model = hyper_models()
    imgs = [image(89), image(90)]
    want = j_analysis.cross_image_matrix(
        j_make_attack_fn(jm, JConfig(steps=STEPS)), j_analysis.make_transfer_eval_fn(jm), jp, imgs)
    with onednn(False):
        got = analysis.cross_image_matrix(make_attack_fn(model, RDAttackConfig(steps=STEPS)),
                                          analysis.make_transfer_eval_fn(model),
                                          [nchw(im) for im in imgs])
    assert got.shape == (2, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=VI_ATOL)


def test_lazy_cross_model_matrix_matches_jax():
    """Two legs, hyper q1 (demo) and factorized q1 (the port's seeded
    weights, carried to JAX): each leg's model is made by its thunk once a
    phase and is gone before the next leg's model is made."""
    jm, jp, _ = hyper_models()
    fact = load_model(Config(device="cpu", model="factorized", quality=1))
    jf = j_init_model("factorized", 1)
    jfp = jax_params_from_port(fact, jf, "factorized")
    del fact
    imgs = [image(91), image(92)]

    def j_leg(module, params, kind):
        def thunk():
            fn = (j_make_attack_fn(module, JConfig(steps=STEPS)) if kind == "attack"
                  else j_analysis.make_transfer_eval_fn(module))
            return fn, params
        return thunk

    want = j_analysis.cross_model_matrix(
        [j_leg(jm, jp, "attack"), j_leg(jf, jfp, "attack")],
        [j_leg(jm, jp, "eval"), j_leg(jf, jfp, "eval")], imgs, log=lambda s: None)

    alive, made, lines = [], [], []

    def leg(arch, ckpt, kind):
        def thunk():
            # the previous leg's model must be gone before this one is made
            gc.collect()
            assert all(ref() is None for ref in alive), "a previous leg's model is alive"
            model = load_model(Config(device="cpu", model=arch, quality=1, checkpoint=ckpt))
            alive.append(weakref.ref(model))
            made.append((arch, kind))
            fn = (make_attack_fn(model, RDAttackConfig(steps=STEPS)) if kind == "attack"
                  else analysis.make_transfer_eval_fn(model))
            return fn, model
        return thunk

    with onednn(False):
        got = analysis.cross_model_matrix(
            [leg("hyper", CKPT, "attack"), leg("factorized", None, "attack")],
            [leg("hyper", CKPT, "eval"), leg("factorized", None, "eval")], imgs,
            log=lines.append)
    assert made == [("hyper", "attack"), ("factorized", "attack"),
                    ("hyper", "eval"), ("factorized", "eval")]
    assert len(lines) == 2 * 2 + 2 * 2  # no memory lines off the card
    np.testing.assert_allclose(got, want, rtol=0, atol=VI_ATOL)
    assert np.all(np.isfinite(got)) and abs(got[0, 1] - got[0, 0]) > 0.1  # two distinct models
