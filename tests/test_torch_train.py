"""The port's training pieces (``train/loss.py``, ``train/step.py``,
``metrics/lpips.py``, ``EntropyBottleneck.aux_loss``,
``attacks/rd.py::make_adv_example_fn``) against the JAX package on the CPU:
hyper q1 on the committed demo weights, 64x64, batch 2, one torch thread,
oneDNN off (``tests/torch_parity.py``).

The training forward's uniform noise cannot be drawn alike on both sides
(``torch.Generator`` against ``jax.random``), so both sides get the same
numpy noise, keyed by shape: ``jax.random.uniform`` and the port's
``ops.quant.uniform_noise`` are replaced for the test with pytest's
``monkeypatch``.  No file of the JAX package changes.

Tolerances, each with its reason:
* losses, bpp and distortions of one forward, the aux loss, LPIPS:
  rtol 1e-5 (float32 sums in another order; measured worst 9.3e-7), plus
  atol 1e-6 on the loss terms: 1 - MS-SSIM cancels, so its float32 value
  carries an absolute error of a few ulps of 1.0 (1.8e-7 between JAX's
  jitted and the port's, 1.4e-5 relative of a distortion of 0.013);
* gradients (step 1 of training, the loss's, the aux loss's): each tensor
  within 1e-4 of its largest element (float32 convolution gradients in
  another order; measured worst 1.75e-5);
* after 3 Adam steps, losses within rtol 1e-3 (measured worst 1.6e-5) and
  parameters within Adam's own bound: a step moves an element by at most
  its lr, so an element whose gradient sits within float32 rounding of
  zero may take the other sign and land up to 2 x lr a step away (the
  amplification of ROADMAP Queue C 3): 2 x 3 x lr, 6e-4 for the main
  group and 6e-3 for the quantiles (measured worst 1.95e-4, in
  ``h_s.4.weight``).  Such elements must stay rare: at most 1e-4 of all
  elements more than lr / 10 apart (measured 1.9e-5: 191 of 10,151,686
  over the two cases).
* the adversarial example (20 steps): pixels atol 1e-4.  Adam amplifies
  float32 gradient error on near-zero-gradient pixels, and the two float32
  trajectories sit apart by more than a single-image attack's: against a
  float64 run of the port (plain GDN, oneDNN off, batches of seeds 3 and 4
  at the three thresholds) JAX's sat up to 1.8e-5 away, the port's up to
  5.3e-5, and port and JAX up to 3.5e-5 (ROADMAP Queue C 3 records the
  same for the attacks).  The joint eval's vi abs 1e-3 dB and bpp rtol 1e-4
  (``tests/torch_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JRDAttackConfig
from imagecompression_adversarial_tpu.attacks.rd import make_adv_example_fn as j_make_adv
from imagecompression_adversarial_tpu.attacks.rd import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.io.convert_lpips import (
    lpips_params_from_torch as j_lpips_params_from_torch,
)
from imagecompression_adversarial_tpu.metrics.lpips import LPIPS as JLPIPS
from imagecompression_adversarial_tpu.metrics.lpips import (
    lpips_fn_from_params as j_lpips_fn_from_params,
)
from imagecompression_adversarial_tpu.train import loss as j_loss
from imagecompression_adversarial_tpu.train import step as j_step
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, evaluate
from imagecompression_adversarial_tpu_torch.attacks.rd import frozen, make_adv_example_fn
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.metrics.lpips import (
    LPIPS,
    lpips_fn_from_params,
    lpips_params_from_jax,
    lpips_params_from_torch,
    make_lpips_fn,
)
from imagecompression_adversarial_tpu_torch.train import (
    LAMBDA_MSE,
    LAMBDA_MSSSIM,
    ReduceLROnPlateau,
    clip_by_global_norm_,
    create_train_state,
    lambda_for,
    parameter_groups,
    quantile_labels,
    rate_distortion_loss,
    recompression_loss,
    train_step,
)
from imagecompression_adversarial_tpu_torch.train.data import synthetic_batches
from torch_parity import (  # noqa: F401  (one_torch_thread, same_noise: fixtures)
    hyper_models, nchw, nhwc, one_torch_thread, onednn, same_noise,
)

LOSS_RTOL = 1e-5
UNIT_ATOL = 1e-6
GRAD_REL = 1e-4
LR = 1e-4
TRAJ_STEPS = 3
PARAM_ATOL = 2 * TRAJ_STEPS * LR
QUANTILE_ATOL = 2 * TRAJ_STEPS * 1e-3
FAR_SHARE = 1e-4
TRAJ_LOSS_RTOL = 1e-3
ADV_IM_ATOL = 1e-4
VI_ATOL = 1e-3
BPP_RTOL = 1e-4


def _model():
    jm, jp, _ = hyper_models()
    from imagecompression_adversarial_tpu_torch.config import Config
    from imagecompression_adversarial_tpu_torch.runtime import load_model
    from torch_parity import CKPT

    # a fresh trainable copy: the cached one is shared by other tests
    model = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    return jm, jp, model.requires_grad_(True)


def _batches(n=3, seed=0):
    stream = synthetic_batches(2, 64, seed)
    return [next(stream) for _ in range(n)]


def _rel_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    return float(np.abs(a - b).max() / scale) <= rel, float(np.abs(a - b).max() / scale)


# -- the loss ---------------------------------------------------------------


def test_lambda_tables_match_jax():
    assert LAMBDA_MSE == j_loss.LAMBDA_MSE and LAMBDA_MSSSIM == j_loss.LAMBDA_MSSSIM
    for metric in ("mse", "ms-ssim"):
        for q in range(1, 9):
            assert lambda_for(metric, q) == j_loss.lambda_for(metric, q)


def _jax_lpips_params(seed=1):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = JLPIPS().init(jax.random.PRNGKey(seed), x, x)["params"]
    # non-trivial heads and input scaling, so that the map of every leaf counts
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for i in range(5):
        params[f"lin{i}"] = rng.uniform(-1, 1, params[f"lin{i}"].shape).astype(np.float32)
    params["features"]["in_shift"] = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    params["features"]["in_scale"] = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    return params


def _result(seed):
    """A codec result as numpy: x_hat and likelihoods, some of them under
    the 1/65536 floor."""
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    x_hat = np.clip(x + 0.05 * rng.randn(*x.shape), 0, 1).astype(np.float32)
    liks = {"y": 10.0 ** rng.uniform(-7, 0, (2, 4, 4, 192)).astype(np.float32),
            "z": 10.0 ** rng.uniform(-7, 0, (2, 1, 1, 128)).astype(np.float32)}
    return x, x_hat, liks


@pytest.mark.parametrize("metric", ["mse", "ms-ssim", "lpips"])
def test_rate_distortion_loss_matches_jax(metric):
    x, x_hat, liks = _result(0)
    lmbda = 0.0018 if metric == "mse" else 2.4
    jp = _jax_lpips_params() if metric == "lpips" else None
    j_fn = j_lpips_fn_from_params(jp) if jp is not None else None
    t_fn = lpips_fn_from_params(lpips_params_from_jax(jp)) if jp is not None else None

    def j_loss_of(xh, lk):
        return j_loss.rate_distortion_loss({"x_hat": xh, "likelihoods": lk}, x, lmbda, metric, j_fn)

    (jv, jout), (jg_x, jg_l) = jax.jit(jax.value_and_grad(
        lambda xh, lk: (lambda o: (o["loss"], o))(j_loss_of(xh, lk)), argnums=(0, 1), has_aux=True
    ))(jnp.asarray(x_hat), {k: jnp.asarray(v) for k, v in liks.items()})

    t_xh = nchw(x_hat).requires_grad_(True)
    t_l = {k: nchw(v).requires_grad_(True) for k, v in liks.items()}
    out = rate_distortion_loss({"x_hat": t_xh, "likelihoods": t_l}, nchw(x), lmbda, metric, t_fn)
    out["loss"].backward()
    for key in ("loss", "bpp_loss", "distortion"):
        np.testing.assert_allclose(float(out[key].detach()), float(jout[key]), rtol=LOSS_RTOL,
                                   atol=UNIT_ATOL, err_msg=key)
    ok, err = _rel_close(nhwc(t_xh.grad), jg_x, GRAD_REL)
    assert ok, f"d loss / d x_hat: {err}"
    for k in liks:
        ok, err = _rel_close(nhwc(t_l[k].grad), jg_l[k], GRAD_REL)
        assert ok, f"d loss / d likelihoods[{k}]: {err}"
    # the gated floor: below 1/65536 the rate's gradient, which points back
    # up, passes at the floor's value
    below = liks["y"] < 1.0 / 65536
    at_floor = -65536.0 / (np.log(2.0) * 2 * 64 * 64)
    assert below.any()
    np.testing.assert_allclose(nhwc(t_l["y"].grad)[below], at_floor, rtol=1e-6)


def test_rate_distortion_loss_rejects_unknown_metric():
    x, x_hat, liks = _result(0)
    with pytest.raises(ValueError, match="metric"):
        rate_distortion_loss({"x_hat": nchw(x_hat), "likelihoods": {}}, nchw(x), 1.0, "psnr")


def test_recompression_loss_matches_jax():
    jm, jp, model = _model()
    x0, x1 = _batches(2)
    want = j_loss.recompression_loss(
        lambda im: jm.apply({"params": jp}, im, method=jm.g_a), jnp.asarray(x0), jnp.asarray(x1))
    with torch.no_grad(), onednn(False):
        got = recompression_loss(model.g_a, nchw(x0), nchw(x1))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# -- LPIPS ------------------------------------------------------------------


def _lpips_state_dict(seed=3, with_net=True):
    """A state dict with the lpips package's AlexNet key names."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.uniform(-0.1, 0.1, s).astype(np.float32))
    state = {}
    if with_net:
        widths = (3, 64, 192, 384, 256, 256)
        kernels = (11, 5, 3, 3, 3)
        for i, key in enumerate(("net.slice1.0", "net.slice2.3", "net.slice3.6",
                                 "net.slice4.8", "net.slice5.10")):
            state[f"{key}.weight"] = t(widths[i + 1], widths[i], kernels[i], kernels[i])
            state[f"{key}.bias"] = t(widths[i + 1])
        state["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
        state["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        state[f"lin{i}.model.1.weight"] = t(1, c, 1, 1).abs()
    return state


@pytest.mark.parametrize("case", ["full", "heads_on_base"])
def test_lpips_key_map_matches_jax(case):
    rng = np.random.RandomState(5)
    a = rng.rand(2, 64, 64, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    full = _lpips_state_dict()
    if case == "full":
        jp = j_lpips_params_from_torch(full)
        tp = lpips_params_from_torch(full)
    else:
        heads = _lpips_state_dict(seed=4, with_net=False)
        jp = j_lpips_params_from_torch(heads, base_params=j_lpips_params_from_torch(full))
        tp = lpips_params_from_torch(heads, base=lpips_params_from_torch(full))
    want = float(j_lpips_fn_from_params(jp)(jnp.asarray(a), jnp.asarray(b)))
    got = float(lpips_fn_from_params(tp)(nchw(a), nchw(b)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert set(tp) == set(LPIPS().state_dict())


def test_lpips_heads_only_without_base_raises():
    with pytest.raises(ValueError, match="base"):
        lpips_params_from_torch(_lpips_state_dict(with_net=False))


def test_lpips_default_is_seeded_and_a_distance():
    """The seeded default (another metric than JAX's default, which draws
    from jax.random): repeatable, zero on equal inputs, and the lpips
    branch of the loss takes it and passes gradients to x_hat."""
    a = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    b = (a + 0.1).clamp(0, 1)
    d1, d2 = make_lpips_fn(0)(a, b), make_lpips_fn(0)(a, b)
    assert float(d1) == float(d2) and float(d1) > 0
    assert float(make_lpips_fn(0)(a, a)) == 0.0
    assert float(make_lpips_fn(1)(a, b)) != float(d1)
    x_hat = b.clone().requires_grad_(True)
    out = rate_distortion_loss({"x_hat": x_hat, "likelihoods": {"y": torch.full((1, 8, 4, 4), 0.5)}},
                               a, 1.0, "lpips")
    out["loss"].backward()
    assert float(out["distortion"]) == float(d1) and float(x_hat.grad.abs().max()) > 0


# -- aux loss, parameter groups, clip, plateau -------------------------------


def test_aux_loss_and_its_gradient_match_jax():
    jm, jp, model = _model()
    jv, jg = jax.value_and_grad(lambda p: jm.apply({"params": p}, method=jm.aux_loss))(jp)
    loss = model.aux_loss()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=LOSS_RTOL)
    want = params_from_jax(jg, "hyper")
    eb = model.entropy_bottleneck
    ok, err = _rel_close(eb.quantiles.grad.numpy(), want["entropy_bottleneck.quantiles"].numpy(),
                         GRAD_REL)
    assert ok, err
    # the gradient reaches only the quantiles
    for name, p in model.named_parameters():
        if name != "entropy_bottleneck.quantiles":
            assert p.grad is None, name
            assert float(want[name].abs().max()) == 0.0, name


def test_parameter_groups_match_quantile_labels():
    jm, jp, model = _model()
    flat = jax.tree_util.tree_flatten_with_path(j_step.quantile_labels(jp))[0]
    j_aux = [jax.tree_util.keystr(p) for p, v in flat if v == "aux"]
    assert j_aux == ["['entropy_bottleneck']['quantiles']"]
    labels = quantile_labels(model)
    assert [n for n, v in labels.items() if v == "aux"] == ["entropy_bottleneck.quantiles"]
    assert len(labels) == len(flat)
    main, aux = parameter_groups(model)
    assert aux == [model.entropy_bottleneck.quantiles]
    ids = {id(p) for p in main} | {id(p) for p in aux}
    assert len(main) + len(aux) == len(ids) == len(list(model.parameters()))


@pytest.mark.parametrize("scale", [0.05, 1.0, 40.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.RandomState(7)
    arrays = [(scale * rng.randn(*s) / 9.0).astype(np.float32) for s in ((3, 4), (17,), (2, 2, 5))]
    want = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in arrays], None)[0]
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    norm = clip_by_global_norm_(grads)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(arrays)), rtol=1e-6)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if float(norm) < 1.0:
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(grads, arrays))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_lr_on_plateau_matches_jax(seed):
    rng = np.random.RandomState(seed)
    # long flat stretches, ties and small gains, where a relative threshold
    # (torch's 1e-4) would give another schedule
    metrics = np.round(np.cumsum(rng.choice([0.0, 0.0, 0.0, -1e-6, 0.01], 200)) + 5.0, 7)
    a, b = ReduceLROnPlateau(1e-4), j_step.ReduceLROnPlateau(1e-4)
    assert [a.step(float(m)) for m in metrics] == [b.step(float(m)) for m in metrics]
    assert a.lr < 1e-4


# -- train steps --------------------------------------------------------------


def _jax_grads(jm, params, batch, lmbda, metric="mse"):
    def loss_fn(p):
        result = jm.apply({"params": p}, batch, quant_mode="noise",
                          rngs={"quant": jax.random.PRNGKey(0)})
        return j_loss.rate_distortion_loss(result, batch, lmbda, metric)["loss"]

    return jax.jit(jax.grad(loss_fn))(params)


@pytest.mark.parametrize("recompress", [False, True])
def test_train_steps_match_jax(same_noise, recompress):
    jm, jp, model = _model()
    batches = _batches(TRAJ_STEPS)
    lmbda = lambda_for("mse", 1)

    # step 1's gradients, tight
    jg = params_from_jax(_jax_grads(jm, jp, jnp.asarray(batches[0]), lmbda), "hyper")
    with onednn(False):
        result = model(nchw(batches[0]), quant_mode="noise", generator=torch.Generator())
        loss = rate_distortion_loss(result, nchw(batches[0]), lmbda, "mse")["loss"]
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    worst = 0.0
    for name, g in zip(names, grads):
        if name == "entropy_bottleneck.quantiles":
            assert g is None or float(g.abs().max()) == 0.0
            continue
        ok, err = _rel_close(g.numpy(), jg[name].numpy(), GRAD_REL)
        worst = max(worst, err)
        assert ok, f"{name}: {err}"

    # 3 steps on both sides
    j_state, j_train_step = j_step.create_train_state(jm, jp)
    j_fn = jax.jit(lambda s, b, r: j_train_step(s, b, r, LR, lmbda, "mse", recompress=recompress))
    state = create_train_state(model, LR)
    for i, b in enumerate(batches):
        j_state, j_logs = j_fn(j_state, jnp.asarray(b), jax.random.PRNGKey(i))
        with onednn(False):
            logs = train_step(state, nchw(b), torch.Generator(), LR, lmbda, "mse", recompress)
        keys = ("loss", "bpp_loss", "distortion", "aux_loss") + (
            ("recompress_loss",) if recompress else ())
        for k in keys:
            rtol = LOSS_RTOL if i == 0 else TRAJ_LOSS_RTOL
            np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), rtol=rtol,
                                       err_msg=f"step {i + 1} {k}")
    assert state.step == int(j_state.step) == TRAJ_STEPS
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, j_state.params), "hyper")
    far = total = 0
    for name, p in model.state_dict().items():
        atol = QUANTILE_ATOL if name.endswith("quantiles") else PARAM_ATOL
        diff = (p - want[name]).abs()
        assert float(diff.max()) <= atol, f"{name}: {float(diff.max())}"
        far += int((diff > atol / (2 * TRAJ_STEPS) / 10).sum())
        total += diff.numel()
    assert far <= FAR_SHARE * total, f"{far} of {total} elements more than lr / 10 apart"
    # the main and aux steps both moved their groups
    first = params_from_jax(jp, "hyper")
    assert float((model.entropy_bottleneck.quantiles - first["entropy_bottleneck.quantiles"])
                 .abs().max()) > 0
    assert float((model.g_a[0].weight - first["g_a.0.weight"]).abs().max()) > 0


# -- the inner attack and its eval ---------------------------------------------


ADV_STEPS = 20


@pytest.fixture(scope="module")
def jax_adv():
    jm, jp, _ = hyper_models()
    fn = jax.jit(j_make_adv(jm, JRDAttackConfig(steps=ADV_STEPS)))
    return lambda x, thr: np.asarray(fn(jp, jnp.asarray(x), jnp.float32(thr)))


@pytest.mark.parametrize("threshold, output_steps", [(0.0, 1), (5e-5, 3), (1e-4, 2)])
def test_adv_example_matches_jax(jax_adv, threshold, output_steps):
    """Both phases run at each threshold: the output phase (one g_a call a
    step, besides the clean forward's) in ``output_steps`` of the 20."""
    _, _, model = _model()
    x = _batches(1, seed=3)[0]
    want = jax_adv(x, threshold)
    calls = []
    hook = model.g_a.register_forward_hook(lambda *_: calls.append(1))
    with onednn(False):
        got = make_adv_example_fn(model, RDAttackConfig(steps=ADV_STEPS))(nchw(x), threshold)
    hook.remove()
    assert len(calls) - 1 == output_steps
    assert float(np.abs(want - x).max()) > 0  # the attack moved the batch
    np.testing.assert_allclose(nhwc(got), want, atol=ADV_IM_ATOL, rtol=0)


def test_adv_example_on_frozen_parameters():
    """The attack runs with no parameter requiring grad, restores the
    flags, leaves no .grad, and gives what a frozen model gives."""
    _, _, model = _model()
    x = nchw(_batches(1, seed=3)[0])
    cfg = RDAttackConfig(steps=3)
    with onednn(False):
        got = make_adv_example_fn(model, cfg)(x, 0.0)
        with frozen(model):
            assert not any(p.requires_grad for p in model.parameters())
            again = make_adv_example_fn(model, cfg)(x, 0.0)
    assert all(p.requires_grad and p.grad is None for p in model.parameters())
    assert torch.equal(got, again)


def test_joint_eval_matches_jax_make_attack_fn():
    """The trainer's --adv eval: JAX's make_attack_fn applied to the batch
    as one image (batch-wide MSEs, bpp over H*W), threshold 1e-4."""
    jm, jp, _ = hyper_models()
    _, _, model = _model()
    x = _batches(1, seed=4)[0]
    want = j_make_attack_fn(jm, JRDAttackConfig(steps=ADV_STEPS, noise_threshold=1e-4))(
        jp, jnp.asarray(x))
    xt = nchw(x)
    with onednn(False):
        im_adv = make_adv_example_fn(model, RDAttackConfig(steps=ADV_STEPS))(xt, 1e-4)
        with torch.no_grad():
            output_s = model(xt, quant_mode="dequantize")["x_hat"].clamp(0, 1)
        got = evaluate(model, im_adv, xt, output_s)
    np.testing.assert_allclose(nhwc(got["im_"]), np.asarray(want["im_"]), atol=ADV_IM_ATOL, rtol=0)
    assert abs(float(got["vi"]) - float(want["vi"])) <= VI_ATOL
    np.testing.assert_allclose(float(got["bpp"]), float(want["bpp"]), rtol=BPP_RTOL)
