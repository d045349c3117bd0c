"""The port's RD attack with a defense in the loop, its defended
evaluation, random restarts and image batches vs the JAX package, on the
CPU (hyper q1 demo weights, 64x64, 5 steps).

Bounds (those of ``tests/test_torch_attack_rd.py``): ``im_`` atol 1e-5 with
oneDNN off and 1e-4 with it on, ``vi`` abs 1e-3, bpp rtol 1e-4.  The
restarts' initial noises are drawn from ``jax.random`` in JAX and from a
``torch.Generator`` in the port, so both sides are handed the same arrays.
A batch of two images must equal two single attacks, and the batched
restarts the sequential ones, within the kernel-vs-plain bounds that
``chip_smoke.py`` holds the card to (``im_`` 1e-4, ``vi`` 1e-3 dB): a batched
convolution sums in another order than a single one, another float32
rounding, which Adam amplifies as below (1.03e-5 measured with 8 threads).

Two deviations, stated with float64 witnesses (runs on one torch thread,
as the tests run).  The ensemble's 8 paths and the resize: JAX and the
port both sit ~1e-5 from a float64 run of the port (plain GDN) after the 5
steps, and not on the same side: ensemble ``scan`` port 9.5e-6 / JAX
7.9e-6 from it, the two 1.04e-5 apart; ``batch`` 9.5e-6 / 7.9e-6, 7.2e-6
apart; resize 2.68e-5 / 2.26e-5, 1.10e-5 apart (bitdepth 9.7e-6 / 9.3e-6,
9.4e-6 apart, and clip meet 1e-5).  Those three cases hold ``im_`` at
5e-5 with oneDNN off.  And restarts start from
uniform(+-1e-2) noise, not from zeros, and there the first Adam step
(``lr * g / (|g| + 1e-8)``) already turns float32 gradient error on pixels
with near-zero gradients into noise error.  After 1 and 5 steps the port's
float32 run (oneDNN off) sat 1.43e-5 to 1.66e-5 from a float64 run of the
port, JAX's 2.7e-6 to 9.5e-6, and the two 8.1e-6 to 1.95e-5 apart.  The
restart comparison holds ``im_`` at 5e-5 with oneDNN off (1e-4 with it
on, as elsewhere); ``vi`` and bpp keep their bounds.
"""

import importlib
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JConfig
from imagecompression_adversarial_tpu.attacks import best_of_restarts as j_best_of_restarts
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu_torch.attacks import (
    RDAttackConfig,
    best_of_restarts,
    make_attack_fn,
    make_batch_attack_fn,
)
from torch_parity import (
    BPP_RTOL, IM_ATOL, VI_ATOL, hyper_models, image, nchw, nhwc, one_torch_thread, onednn,
)  # noqa: F401  (one_torch_thread: an autouse fixture)

j_rd = importlib.import_module("imagecompression_adversarial_tpu.attacks.rd")
j_latent = importlib.import_module("imagecompression_adversarial_tpu.defenses.latent")
j_se = importlib.import_module("imagecompression_adversarial_tpu.defenses.self_ensemble")
rd = importlib.import_module("imagecompression_adversarial_tpu_torch.attacks.rd")
latent = importlib.import_module("imagecompression_adversarial_tpu_torch.defenses.latent")
se = importlib.import_module("imagecompression_adversarial_tpu_torch.defenses.self_ensemble")

STEPS = 5
_JAX = {}


def _profile(jm, jp, x):
    """A rank/dead profile of the clean latent: dead where |y| stays under
    2, each channel's rank as its minimum rank."""
    y = np.asarray(jm.apply({"params": jp}, x, method=jm.g_a))
    absmax = np.abs(y).max(axis=(0, 1, 2))
    order = np.argsort(-absmax, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(order.size)
    return absmax < 2.0, ranks


# batched vs single runs of the port (docstring)
BATCH_IM_ATOL = 1e-4
# im_ atol of the restart, ensemble and resize comparisons, by oneDNN (docstring)
WIDE_IM_ATOL = {False: 5e-5, True: 1e-4}


def _check(res, jres, x, enabled, im_atol=IM_ATOL):
    im_ = nhwc(res["im_"])
    np.testing.assert_allclose(im_, np.asarray(jres["im_"]), atol=im_atol[enabled], rtol=0)
    assert abs(float(res["vi"]) - float(jres["vi"])) <= VI_ATOL
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(float(res[k]), float(jres[k]), rtol=BPP_RTOL)
    assert np.abs(im_ - x).max() <= 16.0 / 255.0 + 1e-6
    assert np.abs(im_ - x).max() > 1e-3  # the attack moved the input


_MODES = [("ensemble", "scan"), ("ensemble", "batch"), ("bitdepth", "scan"),
          ("resize", "scan"), ("clip", "scan")]


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("mode, impl", _MODES)
def test_adaptive_attack_matches_jax(mode, impl, enabled):
    """The attack through each in-loop defense, evaluated through it."""
    jm, jp, model = hyper_models()
    x = image(20)
    kw = dict(steps=STEPS, defend_in_loop=mode, ensemble_impl=impl)
    if mode == "clip":
        dead, ranks = _profile(jm, jp, x)
        j_tf = partial(j_latent.clip_dead_channel, dead=dead, ranks_min=ranks, tolerance=5)
        tf = partial(latent.clip_dead_channel, dead=dead, ranks_min=ranks, tolerance=5)
        j_builder = lambda apply_fn: j_latent.make_latent_defend_fn(jm, jp, j_tf)  # noqa: E731
        builder = lambda m: latent.make_latent_defend_fn(m, tf)  # noqa: E731
    else:
        j_tf = tf = None
        j_builder = lambda apply_fn: j_se.make_defend_fn(apply_fn, mode)  # noqa: E731
        builder = lambda m: se.make_defend_fn(m, mode)  # noqa: E731
    key = (mode, impl)
    if key not in _JAX:
        _JAX[key] = j_make_attack_fn(jm, JConfig(**kw), defend_fn_builder=j_builder,
                                     latent_transform=j_tf)(jp, x)
    with onednn(enabled):
        attack = make_attack_fn(model, RDAttackConfig(**kw), defend_fn_builder=builder,
                                latent_transform=tf)
        res = attack(nchw(x))
    assert attack.cfg.phase_space_loss is False  # off with a defense in the loop
    _check(res, _JAX[key], x, enabled, WIDE_IM_ATOL if mode in ("ensemble", "resize") else IM_ATOL)


def test_defend_in_loop_checks():
    _, _, model = hyper_models()
    with pytest.raises(ValueError, match="defend_in_loop"):
        make_attack_fn(model, RDAttackConfig(defend_in_loop="typo"))
    with pytest.raises(ValueError, match="latent_transform"):
        make_attack_fn(model, RDAttackConfig(defend_in_loop="clip"))
    with pytest.raises(ValueError, match="plain L2"):
        make_attack_fn(model, RDAttackConfig(defend_in_loop="resize", phase_space_loss=True))


def _noises(seed, n=2):
    return np.random.RandomState(seed).uniform(-1e-2, 1e-2, (n, 1, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("enabled", [False, True])
def test_best_of_restarts_matches_jax(monkeypatch, enabled):
    jm, jp, model = hyper_models()
    x = image(21)
    noises = _noises(22)
    kw = dict(steps=STEPS, random_restarts=2, two_phase_impl="select")
    if "restarts" not in _JAX:
        with monkeypatch.context() as m:
            m.setattr(j_rd, "init_noise", lambda shape, cfg, key: jnp.asarray(noises)[key[1]])
            keys = jnp.asarray([[0, 0], [0, 1]], jnp.uint32)
            attack = j_make_attack_fn(jm, JConfig(**kw))
            _JAX["restarts"] = j_best_of_restarts(attack, jp, x, keys, impl="vmap")
            vis = [float(attack(jp, x, k)["vi"]) for k in keys]
        assert vis[0] != vis[1]
    jres = _JAX["restarts"]
    for impl in ("host", "vmap"):
        it = iter(nchw(n) for n in noises)
        monkeypatch.setattr(rd, "init_noise", lambda shape, cfg, generator, device: next(it))
        with onednn(enabled):
            res = best_of_restarts(make_attack_fn(model, RDAttackConfig(**kw)), nchw(x), None, 2,
                                   impl=impl)
        _check(res, jres, x, enabled, WIDE_IM_ATOL)


def test_best_of_restarts_host_and_vmap_draw_the_same_noises():
    _, _, model = hyper_models()
    x = nchw(image(23))
    attack = make_attack_fn(model, RDAttackConfig(steps=2, random_restarts=2))
    with onednn(False):
        out = [best_of_restarts(attack, x, torch.Generator().manual_seed(5), 3, impl=impl)
               for impl in ("host", "vmap")]
    torch.testing.assert_close(out[1]["im_"], out[0]["im_"], atol=BATCH_IM_ATOL, rtol=0)
    assert abs(out[0]["vi"].item() - out[1]["vi"].item()) <= VI_ATOL
    with pytest.raises(ValueError, match="impl"):
        best_of_restarts(attack, x, torch.Generator(), 2, impl="pmap")


@pytest.mark.parametrize("kw", [dict(two_phase_impl="select"), dict(two_phase_impl="cond"),
                                dict(defend_in_loop="ensemble", ensemble_impl="batch")])
def test_batch_attack_equals_single_attacks(kw):
    _, _, model = hyper_models()
    xs = np.concatenate([image(24), image(25)])
    cfg = RDAttackConfig(steps=STEPS, **kw)
    with onednn(False):
        res_b = make_batch_attack_fn(model, cfg)(nchw(xs))
        singles = [make_attack_fn(model, cfg)(nchw(xs[j:j + 1])) for j in range(2)]
    assert res_b["im_"].shape == (2, 1, 3, 64, 64) and res_b["vi"].shape == (2,)
    for j, single in enumerate(singles):
        torch.testing.assert_close(res_b["im_"][j], single["im_"], atol=BATCH_IM_ATOL, rtol=0)
        assert abs(res_b["vi"][j].item() - single["vi"].item()) <= VI_ATOL
        for k in ("bpp", "bpp_ori"):
            np.testing.assert_allclose(res_b[k][j].item(), single[k].item(), rtol=BPP_RTOL)
        for k in ("loss_i_final", "loss_o_final"):
            np.testing.assert_allclose(res_b[k][j].item(), single[k].item(), rtol=1e-4, atol=1e-7)
    assert res_b["vi"][0].item() != res_b["vi"][1].item()
