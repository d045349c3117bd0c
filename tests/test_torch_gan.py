"""The port's HiFiC GAN training (``train/gan.py``,
``models/hific.py::HiFiCDiscriminator`` with its flax-exact spectral norm,
``cli/train_hific.py``) against the JAX package on the CPU, one torch
thread, oneDNN off.

* The losses: rtol 1e-5 (float32 sums in another order), atol 1e-6 on the
  MS-SSIM term (1 - MS-SSIM cancels to a few ulps of 1.0).
* The discriminator at its full widths on 64x64 (and on 72x56, where the
  latent's nearest resize is not by a multiple of 16 and flax's "SAME" pads
  odd sizes (1, 2)), 3 calls with ``update_stats`` on and off from the
  same flax init: logits atol 1e-5 (four float32 convs; measured worst
  ~1e-6), ``u`` atol 1e-5 and ``sigma`` rtol 1e-5 (one power step of
  float32 products).
* Two GAN steps on a narrow codec (hyper q1 on its demo weights; a
  full-width HiFiC step holds ~5 GB across both frameworks) with a
  discriminator over its 192 latent channels, from the same carried
  weights and the same numpy noise (``tests/torch_parity.py::shape_noise``):
  step 1's logs at rtol 1e-5 (atol 1e-6), step 2's at rtol 1e-3 (Adam's
  first step moves every element by about lr, so step 2 starts from
  parameters that already differ by float32 rounding amplified by
  ``m / sqrt(v)``); the parameters of both players within Adam's bound,
  2 x 2 x lr, with at most 1e-4 of the elements more than lr / 10 apart;
  ``u`` atol 1e-4 and ``sigma`` rtol 1e-4 after the two steps.  The G step
  must leave the stats as they were (checked exactly, through a forward
  hook on the discriminator).
* ``cli.train_hific`` at hific's full widths, 2 steps on 64x64 crops: the
  log lines, finite losses, both players and the stats moved, and the
  msgpack it writes read back by the JAX package's
  ``flax.serialization.from_bytes`` (every path and shape of JAX's own
  trees) and by the port's ``load_checkpoint``, equal to the trained
  weights.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.models import init_params as j_init_params
from imagecompression_adversarial_tpu.models.hific import HiFiCDiscriminator as JDisc
from imagecompression_adversarial_tpu.train import gan as j_gan
from imagecompression_adversarial_tpu_torch.cli import train_hific
from imagecompression_adversarial_tpu_torch.io.weights import (
    GAN_KEYS,
    discriminator_from_jax,
    flax_params,
    load_checkpoint,
    params_from_jax,
    read_msgpack,
    write_msgpack,
)
from imagecompression_adversarial_tpu_torch.models.hific import (
    HiFiCDiscriminator,
    init_discriminator,
)
from imagecompression_adversarial_tpu_torch.train import gan
from imagecompression_adversarial_tpu_torch.train.data import synthetic_batches
from torch_parity import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    hyper_models, nchw, nhwc, one_torch_thread, onednn, shape_noise,
)

LOSS_RTOL = 1e-5
UNIT_ATOL = 1e-6
LOGIT_ATOL = 1e-5
U_ATOL = 1e-5
SIGMA_RTOL = 1e-5
LR = 1e-4
STEPS = 2
STEP2_RTOL = 1e-3
PARAM_ATOL = 2 * STEPS * LR
FAR_SHARE = 1e-4
STATS_ATOL = 1e-4


def discriminator_stats_to_jax(disc):
    """The port's ``u`` and ``sigma`` buffers as flax's ``batch_stats``:
    ``SpectralNorm_i`` in call order (``conv_0`` .. ``conv_3``, then
    ``logits``)."""
    names = [f"conv_{i}" for i in range(4)] + ["logits"]
    return {f"SpectralNorm_{i}": {f"{n}/kernel/{b}": getattr(disc, n).get_buffer(b)
                                  .detach().numpy().copy() for b in ("sigma", "u")}
            for i, n in enumerate(names)}


def _disc_pair(latent_ch, h=64, w=64, seed=2):
    """A flax discriminator's (module, params, stats) from its init and the
    port's with the same weights."""
    jd = JDisc()
    x = jnp.zeros((1, h, w, 3))
    y = jnp.zeros((1, -(-h // 16), -(-w // 16), latent_ch))
    v = jd.init(jax.random.PRNGKey(seed), x, y, train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    disc = HiFiCDiscriminator(latent_ch)
    disc.load_state_dict(discriminator_from_jax(params, stats), strict=True)
    return jd, params, stats, disc


def _stats_close(got, want, atol=U_ATOL, rtol=SIGMA_RTOL):
    for mod, node in want.items():
        for name, value in node.items():
            a = np.asarray(got[mod][name])
            if name.endswith("/u"):
                np.testing.assert_allclose(a, value, atol=atol, err_msg=f"{mod}/{name}")
            else:
                np.testing.assert_allclose(a, value, rtol=rtol, err_msg=f"{mod}/{name}")


def test_gan_losses_match_jax():
    rng = np.random.RandomState(0)
    real, fake = (rng.randn(2, 4, 4, 1).astype(np.float32) * 3 for _ in range(2))
    t_real, t_fake = nchw(real), nchw(fake)
    np.testing.assert_allclose(float(gan.non_saturating_g_loss(t_fake)),
                               float(j_gan.non_saturating_g_loss(fake)), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(gan.non_saturating_d_loss(t_real, t_fake)),
                               float(j_gan.non_saturating_d_loss(real, fake)), rtol=LOSS_RTOL)

    target = rng.rand(2, 64, 64, 3).astype(np.float32)
    x_hat = np.clip(target + 0.1 * rng.randn(*target.shape), -0.1, 1.1).astype(np.float32)
    liks = {"y": rng.uniform(0.01, 1, (2, 4, 4, 8)).astype(np.float32),
            "z": rng.uniform(0.01, 1, (2, 1, 1, 4)).astype(np.float32)}
    j_total, j_logs = j_gan.hific_generator_loss(
        {"x_hat": x_hat, "likelihoods": liks}, target, fake)
    total, logs = gan.hific_generator_loss(
        {"x_hat": nchw(x_hat), "likelihoods": {k: nchw(v) for k, v in liks.items()}},
        nchw(target), t_fake)
    for k in ("bpp", "mse", "perceptual", "g_adv", "loss"):
        np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), rtol=LOSS_RTOL,
                                   atol=UNIT_ATOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(j_total), rtol=LOSS_RTOL)


@pytest.mark.parametrize("size", [(64, 64), (72, 56)])
@pytest.mark.parametrize("update_stats", [True, False])
def test_discriminator_matches_flax(size, update_stats):
    h, w = size
    jd, params, stats, disc = _disc_pair(220, h, w)
    rng = np.random.RandomState(1)
    j_stats = stats
    for call in range(3):
        x = rng.rand(2, h, w, 3).astype(np.float32)
        y = rng.randn(2, -(-h // 16), -(-w // 16), 220).astype(np.float32)
        if update_stats:
            j_logits, vs = jd.apply({"params": params, "batch_stats": j_stats}, x, y,
                                    train=True, mutable=["batch_stats"])
            j_stats = jax.tree_util.tree_map(np.asarray, vs["batch_stats"])
        else:
            j_logits = jd.apply({"params": params, "batch_stats": j_stats}, x, y, train=False)
        with onednn(False), torch.no_grad():
            logits = disc(nchw(x), nchw(y), update_stats=update_stats)
        assert logits.shape == (2, 1, -(-h // 16), -(-w // 16))
        np.testing.assert_allclose(nhwc(logits), np.asarray(j_logits), atol=LOGIT_ATOL,
                                   err_msg=f"call {call}")
        _stats_close(discriminator_stats_to_jax(disc), j_stats)
    if not update_stats:  # the stats stayed as initialized
        for mod, node in stats.items():
            for name, value in discriminator_stats_to_jax(disc)[mod].items():
                np.testing.assert_array_equal(value, node[name])


def _one_step_sigma(kernel_hwio, u):
    w = np.asarray(kernel_hwio, np.float64).reshape(-1, kernel_hwio.shape[-1])
    v = u @ w.T
    v = v / np.linalg.norm(v)
    u1 = v @ w
    return float((v @ w @ (u1 / np.linalg.norm(u1)).T)[0, 0])


def test_discriminator_init_follows_flax():
    """The seeded init stores what flax's does: a ``lecun_normal`` kernel
    (truncated at two of its standard deviations, variance 1 / fan_in)
    divided by the sigma of one power step from the initial ``u``, so that
    a power step from ``u`` reads sigma 1; zero biases, ``u`` standard
    normal, ``sigma`` 1; ``latent_proj`` keeps the repo's ``Conv`` init."""
    _, params, stats, _ = _disc_pair(220)
    disc = init_discriminator(220, seed=1)
    port = flax_params(disc)
    port_stats = discriminator_stats_to_jax(disc)
    for i in range(4):
        name, sn = f"conv_{i}", f"SpectralNorm_{i}"
        for kernel, st in ((port[name]["kernel"], port_stats[sn]),
                           (params[name]["kernel"], stats[sn])):
            u = np.asarray(st[f"{name}/kernel/u"], np.float64)
            assert abs(_one_step_sigma(kernel, u) - 1.0) < 1e-5
            assert float(st[f"{name}/kernel/sigma"]) == 1.0
            fan_in = kernel[..., 0].size
            assert 0.7 < kernel.std() * np.sqrt(fan_in) < 1.0  # 1 / sigma of ~1.1-1.3
        assert not port[name]["bias"].any()
    u = np.concatenate([port_stats[f"SpectralNorm_{i}"][f"conv_{i}/kernel/u"].ravel()
                        for i in range(4)])
    assert abs(u.std() - 1.0) < 0.1 and abs(u.mean()) < 0.1
    lat = disc.latent_proj.weight.detach().numpy()
    assert np.abs(lat).max() <= np.sqrt(3.0 / lat[0].size)


def test_latent_resize_is_jax_nearest():
    """``nearest-exact`` is ``jax.image.resize(..., "nearest")``, also where
    the target size is not a multiple of the source's."""
    lat = np.random.RandomState(3).randn(1, 5, 4, 12).astype(np.float32)
    want = jax.image.resize(lat, (1, 72, 56, 12), method="nearest")
    got = torch.nn.functional.interpolate(nchw(lat), size=(72, 56), mode="nearest-exact")
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def _trees_close(got, want, what):
    far = total = 0
    for name, value in want.items():
        diff = (got[name].detach() - value).abs()
        assert float(diff.max()) <= PARAM_ATOL, f"{what} {name}: {float(diff.max())}"
        far += int((diff > LR / 10).sum())
        total += diff.numel()
    assert far <= FAR_SHARE * total, f"{what}: {far} of {total} elements more than lr / 10 apart"


def test_gan_steps_match_jax(shape_noise):
    jm, jp, _ = hyper_models()
    from imagecompression_adversarial_tpu_torch.config import Config
    from imagecompression_adversarial_tpu_torch.runtime import load_model
    from torch_parity import CKPT

    codec = load_model(Config(device="cpu", model="hyper", quality=1, checkpoint=CKPT))
    codec.requires_grad_(True)
    jd, d_params, d_stats, disc = _disc_pair(192)
    stream = synthetic_batches(2, 64, seed=5)
    batches = [next(stream) for _ in range(STEPS)]

    g_opt, d_opt = optax.adam(LR), optax.adam(LR)
    j_step = jax.jit(j_gan.make_gan_train_step(jm, jd, g_opt, d_opt))
    j_state = (jp, d_params, d_stats, g_opt.init(jp), d_opt.init(d_params))
    step = gan.make_gan_train_step(codec, disc, torch.optim.Adam(codec.parameters(), lr=LR),
                                   torch.optim.Adam(disc.parameters(), lr=LR))

    seen = []
    hook = disc.register_forward_hook(
        lambda m, a, kw, out: seen.append((kw["update_stats"], discriminator_stats_to_jax(m))),
        with_kwargs=True)
    try:
        for i, b in enumerate(batches):
            before = discriminator_stats_to_jax(disc)
            *j_state, j_logs = j_step(*j_state, jnp.asarray(b), jax.random.PRNGKey(i))
            seen.clear()
            with onednn(False):
                logs = step(nchw(b), torch.Generator())
            # the G step's pass left the stats as they were; the D step's two
            # passes updated them
            assert [s[0] for s in seen] == [False, True, True]
            for mod, node in before.items():
                for name, value in node.items():
                    np.testing.assert_array_equal(seen[0][1][mod][name], value)
            rtol = LOSS_RTOL if i == 0 else STEP2_RTOL
            for k in ("loss", "bpp", "mse", "perceptual", "g_adv", "d_loss"):
                np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), rtol=rtol,
                                           atol=UNIT_ATOL, err_msg=f"step {i + 1} {k}")
    finally:
        hook.remove()
    j_state = jax.tree_util.tree_map(np.asarray, j_state)
    _trees_close(codec.state_dict(), params_from_jax(j_state[0], "hyper"), "generator")
    want_disc = discriminator_from_jax(j_state[1], j_state[2])
    _trees_close(disc.state_dict(), {k: v for k, v in want_disc.items()
                                     if not k.endswith((".u", ".sigma"))}, "discriminator")
    _stats_close(discriminator_stats_to_jax(disc), j_state[2], atol=STATS_ATOL, rtol=STATS_ATOL)
    # both players moved
    first = discriminator_from_jax(d_params, d_stats)
    assert float((disc.conv_0.weight.detach() - first["conv_0.weight"]).abs().max()) > 0


def test_train_hific_cli_full_width(tmp_path, monkeypatch, capsys):
    """Two steps of ``cli.train_hific`` at hific's full widths on 64x64
    crops (batch 1, the batches replaced for the test); the file it writes
    holds JAX's trees."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_hific, "make_batches",
                        lambda root, batch_size, crop: synthetic_batches(1, 64, seed=6))
    torch.manual_seed(0)
    out = str(tmp_path / "gan" / "hific.msgpack")
    before = discriminator_stats_to_jax(init_discriminator(220, seed=1))
    with onednn(False):
        logs = train_hific.main(["-device", "cpu", "-max_steps", "2", "-ckpt", out])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step 0 loss ") and " d " in lines[0] and lines[0].endswith("s")
    assert lines[-1] == f"saved -> {out}"
    assert set(logs) == {"loss", "bpp", "mse", "perceptual", "g_adv", "d_loss"}
    assert all(np.isfinite(v) for v in logs.values())

    with open(out, "rb") as f:
        raw = f.read()
    codec_t = jax.eval_shape(lambda k: j_init_params(j_init_model("hific", 3), k, (1, 64, 64, 3)),
                             jax.random.PRNGKey(0))
    disc_t = jax.eval_shape(lambda k: JDisc().init(k, jnp.zeros((1, 64, 64, 3)),
                                                   jnp.zeros((1, 4, 4, 220)), train=False),
                            jax.random.PRNGKey(1))["params"]
    template = {"generator": codec_t, "discriminator": disc_t}
    restored = flax.serialization.from_bytes(template, raw)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(template)[0])
    flat_r = dict(jax.tree_util.tree_flatten_with_path(restored)[0])
    assert flat_t.keys() == flat_r.keys()
    for path, sd in flat_t.items():
        assert tuple(np.shape(flat_r[path])) == tuple(sd.shape), path

    tree = read_msgpack(out)
    assert set(tree) == set(GAN_KEYS)
    trained = load_checkpoint(out, "hific")
    fresh = train_hific.init_model("hific", 3, seed=0).state_dict()
    assert trained.keys() == fresh.keys()
    assert any(not torch.equal(trained[k], fresh[k]) for k in fresh)  # the generator moved
    d_trained = discriminator_from_jax(tree["discriminator"], before)
    d_fresh = flax_params(init_discriminator(220, seed=1))
    assert float(np.abs(tree["discriminator"]["conv_0"]["kernel"]
                        - d_fresh["conv_0"]["kernel"]).max()) > 0
    assert d_trained["conv_0.weight"].shape == (64, 15, 4, 4)


def test_msgpack_writer_is_flax_to_bytes(tmp_path):
    """``write_msgpack`` writes ``flax.serialization.to_bytes``'s bytes, for
    a tree with 0-d, small and large arrays and long names."""
    rng = np.random.RandomState(7)
    tree = {"a": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                  "sigma": np.array(rng.randn(), np.float32), "step": np.int32(3)},
            "b" * 40: {"u": rng.randn(1, 1).astype(np.float32),
                       "big": rng.randn(300, 300).astype(np.float32)},
            **{f"Dense_{i}": {"bias": rng.randn(i + 1).astype(np.float32)} for i in range(20)}}
    path = str(tmp_path / "t.msgpack")
    write_msgpack(path, tree)
    with open(path, "rb") as f:
        assert f.read() == flax.serialization.to_bytes(tree)
    back = read_msgpack(path)
    np.testing.assert_array_equal(back["b" * 40]["big"], tree["b" * 40]["big"])
    assert back["a"]["sigma"].shape == () and back["a"]["step"] == 3
