"""The port's sign-gradient attacks (``attacks/ifgsm.py``) and CW attack
(``attacks/cw.py``) vs the JAX package, on the CPU (hyper q1 demo weights,
64x64).

Sign steps: a gradient component within float noise of 0 may take the
other sign in the other implementation and move its pixel by 2 alpha, so
the update rule is compared exactly on a fixed gradient, and the 6-step
trajectories (BIM, PGD from the same start, MI-FGSM) are held to: at most
0.5% of pixels more than 1e-6 apart, and vi within 1e-2 dB.

CW (``-ssteps 2``, 4 Adam steps a round, normal and ``fast``): the same
outer round count, and vi within 1e-3 dB of JAX's; ``im_`` within 5e-4 and
bpp_ori, bpp as elsewhere.  CW's Adam runs at a constant lr of 1e-2, so
float32 noise grows further than in the RD attack: on three test images,
with one torch thread, the port's ``im_`` sat 2.7e-5 to 1.5e-4 from a
float64 run of the port (plain GDN), JAX's 2.8e-5 to 1.6e-4, the two
1.9e-5 to 1.1e-4 apart.  One case is held apart: ``fast`` on image 33
evaluates an input with a latent value at a rounding boundary, and vi
there is bistable between 10.5904 and 10.6809 dB (JAX 10.6809; the port
10.5904 with 8 threads and 10.6809 with 1; the float64 run 10.590356),
bpp between 0.30346 and 0.30325.  That case holds vi within 0.1 dB (one
flipped symbol) of JAX and of the float64 run, bpp at 1e-3, and its
bisection decisions equal to the float64 run's; image 35 holds ``fast`` at
1e-3 dB.

The momentum's L1 norm is a float32 sum whose order may differ, so the
momentum buffer is compared at rtol 1e-6 and the image exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import CWAttackConfig as JCWConfig
from imagecompression_adversarial_tpu.attacks import IFGSMConfig as JIFGSMConfig
from imagecompression_adversarial_tpu.attacks import make_cw_attack_fn as j_make_cw
from imagecompression_adversarial_tpu.attacks import make_ifgsm_fn as j_make_ifgsm
from imagecompression_adversarial_tpu_torch.attacks import (
    CWAttackConfig,
    IFGSMConfig,
    best_of_multistart,
    make_cw_attack_fn,
    make_ifgsm_fn,
)
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    BPP_RTOL, VI_ATOL, hyper_models, image, nchw, nhwc, one_torch_thread, onednn,
)

ifgsm = importlib.import_module("imagecompression_adversarial_tpu_torch.attacks.ifgsm")

# sign-step trajectories (docstring)
FLIP_SHARE = 0.005
FLIP_ATOL = 1e-6
SIGN_VI_ATOL = 1e-2
_JAX = {}


def _jax_sign_step(im_adv, g, grad, x, alpha, eps, momentum):
    """The step of the JAX package's scan body (attacks/ifgsm.py:108-118)."""
    if momentum:
        g = g + grad / jnp.sum(jnp.abs(grad))
        im_adv = jnp.clip(im_adv + alpha * jnp.sign(g), 0.0, 1.0)
    else:
        im_adv = im_adv + alpha * jnp.sign(grad)
    return jnp.clip(im_adv, x - eps, x + eps), g


@pytest.mark.parametrize("momentum", [False, True])
def test_sign_step_matches_jax_exactly(momentum):
    rng = np.random.RandomState(30)
    x = rng.rand(1, 16, 16, 3).astype(np.float32)
    eps, alpha = 16.0 / 255.0, 16.0 / 255.0 / 7
    im, g = x.copy(), np.zeros_like(x)
    tim, tg = nchw(x), torch.zeros_like(nchw(x))
    for _ in range(5):
        grad = rng.randn(*x.shape).astype(np.float32)
        grad[0, 0, :4] = 0.0  # sign(0) = 0: the pixel stays
        im, g = _jax_sign_step(jnp.asarray(im), jnp.asarray(g), jnp.asarray(grad), x, alpha, eps,
                               momentum)
        tim, tg = ifgsm.sign_step(tim, tg, nchw(grad), nchw(x), alpha, eps, momentum)
        np.testing.assert_array_equal(nhwc(tim), np.asarray(im))
        np.testing.assert_allclose(nhwc(tg), np.asarray(g), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(np.asarray(g)).max()))
    assert np.abs(np.asarray(im) - x).max() <= eps + 1e-7


_VARIANTS = {"bim": {}, "pgd": {"random_start": True}, "mifgsm": {"momentum": True}}


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_ifgsm_trajectory_matches_jax(monkeypatch, variant, enabled):
    jm, jp, model = hyper_models()
    x = image(31)
    kw = dict(steps=6, **_VARIANTS[variant])
    key = jax.random.PRNGKey(7)
    if variant not in _JAX:
        _JAX[variant] = j_make_ifgsm(jm, JIFGSMConfig(**kw))(jp, x, key)
    jres = _JAX[variant]
    eps = 16.0 / 255.0
    start = np.clip(x + np.asarray(jax.random.uniform(key, x.shape, jnp.float32, -eps, eps)), 0, 1)
    monkeypatch.setattr(ifgsm, "random_start", lambda x_, eps_, gen: nchw(start))
    with onednn(enabled):
        res = make_ifgsm_fn(model, IFGSMConfig(**kw))(nchw(x), torch.Generator())
    im_ = nhwc(res["im_"])
    share = float(np.mean(np.abs(im_ - np.asarray(jres["im_"])) > FLIP_ATOL))
    assert share <= FLIP_SHARE, share
    assert abs(res["vi"].item() - float(jres["vi"])) <= SIGN_VI_ATOL
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=BPP_RTOL)
    assert np.abs(im_ - x).max() <= eps + 1e-6 and np.abs(im_ - x).max() > 1e-3


def test_pgd_start_and_multistart():
    _, _, model = hyper_models()
    x = nchw(image(32))
    eps = 16.0 / 255.0
    s = ifgsm.random_start(x, eps, torch.Generator().manual_seed(0))
    assert (s - x).abs().max() <= eps + 1e-7 and s.min() >= 0 and s.max() <= 1
    assert (s - x).abs().max() > 0.9 * eps
    attack = make_ifgsm_fn(model, IFGSMConfig(steps=2, random_start=True))
    with pytest.raises(ValueError, match="Generator"):
        attack(x)
    calls = []

    def counted(x_, gen):
        res = attack(x_, gen)
        calls.append(res["vi"].item())
        return res

    best = best_of_multistart(counted, x, torch.Generator().manual_seed(1), 3)
    assert len(calls) == 3 and len(set(calls)) == 3  # each start drew its own noise
    assert best["vi"].item() == max(calls)


def _float64_witness(model, cfg, x):
    import copy

    from imagecompression_adversarial_tpu_torch.models.layers import GDN

    m64 = copy.deepcopy(model).double()
    for m in m64.modules():
        if isinstance(m, GDN):
            m.use_kernel = False
    with onednn(False):
        return make_cw_attack_fn(m64, cfg)(nchw(x).double())


@pytest.mark.parametrize("seed, fast", [(33, False), (33, True), (35, True)])
def test_cw_matches_jax(seed, fast):
    jm, jp, model = hyper_models()
    x = image(seed)
    kw = dict(steps=4, search_steps=2, fast=fast)
    jres = j_make_cw(jm, JCWConfig(**kw))(jp, x)
    with onednn(False):
        res = make_cw_attack_fn(model, CWAttackConfig(**kw))(nchw(x))
    assert res["outer_rounds"] == int(jres["outer_rounds"]) == len(res["decisions"])
    np.testing.assert_allclose(nhwc(res["im_"]), np.asarray(jres["im_"]), atol=5e-4, rtol=0)
    np.testing.assert_allclose(res["loss_i_final"].item(), float(jres["loss_i_final"]), rtol=1e-3)
    bistable = (seed, fast) == (33, True)  # docstring
    for k in ("bpp_ori", "bpp"):
        np.testing.assert_allclose(res[k].item(), float(jres[k]), rtol=1e-3 if bistable else BPP_RTOL)
    if bistable:
        w64 = _float64_witness(model, CWAttackConfig(**kw), x)
        assert w64["decisions"] == res["decisions"]
        assert abs(res["vi"].item() - w64["vi"].item()) <= 0.1
        assert abs(res["vi"].item() - float(jres["vi"])) <= 0.1
    else:
        assert abs(res["vi"].item() - float(jres["vi"])) <= VI_ATOL
    if not fast:  # the amplitude search keeps mse_in within one 8-bit step of the budget
        assert res["mse_in"].item() <= 1e-4 * 1.5
    for d in res["decisions"]:
        assert 1 <= len(d["reached"]) <= 8 if fast else len(d["reached"]) == 2
