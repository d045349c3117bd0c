"""Row sharding of the five adapter families (hific, invcompress, tic, fic,
nlaic) in the port's parallel layer, against JAX's unsharded run and the
port's one-process run on the CPU.

The ranks run in a 2-rank gloo world spawned once for the module (their
side is ``tests/torch_spmd_cases.py``), in a background thread while the
tests compute the JAX side here; a 4-rank world runs the row roll alone.
Each family runs at q3 on a 128x128 image (64 rows a rank; tic's 1/16
block is one window of 4 rows, so its shifted roll wraps across the
ranks): tic, fic and nlaic on their demo trees, hific and invcompress on
seeded weights moved by 0.01 x normal noise, handed to JAX through
``torch_parity.jax_params_from_port``.  The ranks and the one-process runs
take one torch thread with oneDNN off.

Bounds, each with its source:
* the sp=2 ``dequantize`` forward against JAX's unsharded one: the
  families' own forward bounds (``tests/test_torch_adapters.py``,
  ``test_torch_invcompress.py``, ``test_torch_fic.py``): x_hat within
  1e-4 of its largest magnitude, every likelihood atol 1e-4; against the
  one-process run, the sp bounds of ``tests/test_torch_parallel.py``:
  x_hat atol 1e-5, the log-likelihood sums rtol 1e-4;
* the 3-step ``select`` attack (fic from the same initial noise) in
  float64 against the one-process float64 run: every scalar rtol 1e-9 and
  ``im_`` atol 1e-9 (measured: equal).  That is the check that the sharded
  codec, its gradient and the two-phase decisions are the one process's:
  in float32, Adam (lr / eps = 1e6) turns rounding error on pixels whose
  gradient is near 1e-8 into noise error, so the sharded and one-process
  float32 runs part on such pixels as any two float32 runs do;
* the same attack in float32 against JAX's unsharded one, each family at
  ATTACK_VS_JAX: bpp_ori rtol 1e-4 (a forward; also against one process),
  vi, bpp and ``im_`` at bounds witnessed against the float64 run of the
  port at this size, since the families' 64x64 ``im_`` bounds do not
  carry to 128x128 for JAX itself (max |im_ - float64|, share of the
  elements past 1e-4): nlaic JAX 7.9e-5, the port 4.5e-6 (one process and
  sp=2) -> 1e-4 (its 64x64 bound was 1e-5); tic JAX 3.1e-5, the port
  4.0e-5 -> 1e-4, its own; fic JAX 4.3e-5, the port 8.1e-5 -> 1e-3, its
  own; invcompress (its gradient is its rounding error) JAX 2.23e-2
  (0.32%), the port 2.15e-2 (0.36%), sp=2 from JAX 2.23e-2 (0.57%), vi
  3.9e-3 dB and bpp 9.5e-4 apart -> 1% past 1e-4, none past 3e-2, vi
  0.05 dB and bpp 2e-3 (its own vi and bpp bounds); hific (seeded
  weights: 69% of its outputs clip) JAX 3.7e-4 (0.03%), but the port's
  float32 run 1.16e-2 (9.7%) in one process and 1.21e-2 (12.9%) on sp=2,
  vi 0.027 and 0.011 dB from JAX's 17.3256, which the float64 run
  matches -> 20% past 1e-4, none past 3e-2 (Adam moves a pixel at most
  lr = 1e-2 a step), vi 0.05 dB; bpp rtol 1e-4.  hific's float32 spread is
  the port's own on the CPU (one attack step already flips 0.5% of the
  pixels, JAX's none; its forward and x-gradient errors equal JAX's), not
  the sharding's;
* the nlaic split attack (float32) against the one-process split attack:
  the sp bounds (scalars rtol 1e-4, atol 1e-6; ``im_`` atol 1e-5);
* ``roll_rows`` against ``torch.roll``, and ``shared_rows`` against the
  whole tensor: values exact (rows are copied), gradients atol 1e-6 (the
  roll's exact; the sum over ranks in another order); the sp=2 non-local
  block's output, input and parameter gradients atol 1e-5 (float32 sums
  in another order);
* the k=3 and k=5 subpixel ``Deconv`` against ``ConvTranspose2d``:
  atol 1e-12 in float64.
"""

import copy
import functools

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JRDAttackConfig
from imagecompression_adversarial_tpu.attacks import make_attack_fn as j_make_attack_fn
from imagecompression_adversarial_tpu.attacks import rd as j_rd
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
from imagecompression_adversarial_tpu_torch.metrics import bpp_from_likelihoods
from imagecompression_adversarial_tpu_torch.models import invcompress, tic
from imagecompression_adversarial_tpu_torch.models.layers import Deconv, depth_to_space
from imagecompression_adversarial_tpu_torch.models.nlaic import NonLocalBlock
from imagecompression_adversarial_tpu_torch.ops import shard

import torch_spmd_cases as cases
from torch_parity import (  # noqa: F401  (one_torch_thread: a fixture)
    image, jax_params_from_port, nchw, nhwc, one_torch_thread, onednn, perturb_,
)

FAMILIES = cases.ADAPTERS
SIZE = 128
WORLD_TIMEOUT_S = 600
SCENARIOS_2 = [f"sp2_{f}" for f in FAMILIES] + ["sp2_nlaic_split", "roll_rows_case",
                                                "shared_rows_case"]
SCENARIOS_4 = ["roll_rows_case"]
ROLL_SHIFTS = (-2, 2, -1, 1)

# the float32 attack against JAX's unsharded run, by family: vi (dB), bpp
# (relative), at most `share` of im_'s elements more than `far` apart and
# none more than `max` (the docstring's witnesses)
ATTACK_VS_JAX = {
    "nlaic": dict(vi=1e-3, bpp=1e-4, far=1e-4, share=0.0, max=1e-4),
    "tic": dict(vi=1e-3, bpp=1e-4, far=1e-4, share=0.0, max=1e-4),
    "fic": dict(vi=1e-3, bpp=1e-4, far=1e-3, share=0.0, max=1e-3),
    "invcompress": dict(vi=0.05, bpp=2e-3, far=1e-4, share=1e-2, max=3e-2),
    "hific": dict(vi=0.05, bpp=1e-4, far=1e-4, share=0.2, max=3e-2),
}
F64_RTOL = 1e-9
F64_IM_ATOL = 1e-9
SP_IM_ATOL = 1e-5


def _inputs():
    rng = np.random.RandomState(12)
    nl = perturb_(NonLocalBlock(8), 0.1, seed=3)
    return {
        "adapter_x": image(11, SIZE, SIZE),
        "fic_noise": np.random.RandomState(6).uniform(-0.01, 0.01, (1, SIZE, SIZE, 3))
                     .astype(np.float32),
        "roll_x": rng.randn(1, 3, 8, 5).astype(np.float32),
        "roll_w": rng.randn(1, 3, 8, 5).astype(np.float32),
        "roll_shifts": ROLL_SHIFTS,
        "nl_x": rng.randn(1, 8, 6, 5).astype(np.float32),
        "nl_w": rng.randn(1, 8, 6, 5).astype(np.float32),
        "nl_state": {k: v.detach().numpy() for k, v in nl.state_dict().items()},
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = cases.StreamedWorlds(_inputs(), tmp_path_factory.mktemp("spmd_adapters"),
                             {2: SCENARIOS_2, 4: SCENARIOS_4}, WORLD_TIMEOUT_S)
    yield w
    w.close()


@functools.lru_cache(maxsize=1)  # the tests of a family run in a row
def _models(fam):
    """(JAX module, numpy params, port model) of ``fam`` q3 on the ranks'
    weights."""
    jm = j_init_model(fam, 3)
    model = cases.adapter_model(fam)
    ckpt = cases.DEMO / f"{fam}-q3-mse-synthetic.msgpack"
    if ckpt.is_file():
        with open(ckpt, "rb") as f:
            jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        flax.serialization.msgpack_restore(f.read()))
    else:
        jp = jax_params_from_port(model, jm, fam)
    return jm, jp, model


def _rows(ranks, key=None):
    """The ranks' NHWC rows, stacked into the whole image."""
    return np.concatenate([r if key is None else r[key] for r in ranks], axis=1)


def _one_process(model, fam, inputs, dtype=torch.float32, **kw):
    """The port's attack on the whole image in this process, as the ranks
    run it (one thread, oneDNN off, the same initial noise)."""
    x = nchw(inputs["adapter_x"]).to(dtype)
    with onednn(False):
        return make_attack_fn(model, RDAttackConfig(**kw)).run(
            x, cases.adapter_noise(inputs, fam, dtype))


def _check_forward(worlds, monkeypatch, fam):
    """The sp=2 ``dequantize`` forward against JAX's and one process's."""
    jm, jp, model = _models(fam)
    x = worlds.inputs["adapter_x"]
    want = jax.jit(lambda p, im: jm.apply({"params": p}, im, quant_mode="dequantize"))(jp, x)
    with torch.no_grad(), onednn(False):
        one = model(nchw(x), quant_mode="dequantize")
    ranks = [r["forward"] for r in worlds.ranks(f"sp2_{fam}")]
    x_hat = _rows(ranks, "x_hat")
    ref = np.asarray(want["x_hat"])
    np.testing.assert_allclose(x_hat, ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))
    np.testing.assert_allclose(x_hat, nhwc(one["x_hat"]), rtol=0, atol=1e-5)
    assert set(want["likelihoods"]) == set(ranks[0]["lik"])
    for k, lik in want["likelihoods"].items():
        np.testing.assert_allclose(_rows([r["lik"][k] for r in ranks]), np.asarray(lik),
                                   rtol=0, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(sum(r["loglik"][k] for r in ranks),
                                   float(torch.log(one["likelihoods"][k]).double().sum()),
                                   rtol=1e-4, err_msg=k)


def _check_attack(worlds, monkeypatch, fam):
    """The sp=2 float32 attack against JAX's unsharded one (ATTACK_VS_JAX)
    and one process's rate of the clean image."""
    jm, jp, model = _models(fam)
    inputs = worlds.inputs
    if fam == "fic":  # the same initial noise on both sides
        monkeypatch.setattr(j_rd, "init_noise",
                            lambda shape, cfg, key: jnp.asarray(inputs["fic_noise"]))
    want = j_make_attack_fn(jm, JRDAttackConfig(**cases.ADAPTER_ATTACK))(jp, inputs["adapter_x"])
    bound = ATTACK_VS_JAX[fam]
    ranks = [r["attack"] for r in worlds.ranks(f"sp2_{fam}")]
    with torch.no_grad(), onednn(False):
        bpp_ori = bpp_from_likelihoods(model(nchw(inputs["adapter_x"]), "dequantize")["likelihoods"],
                                       SIZE * SIZE).item()
    for got in ranks:
        assert got["rows"] == (1, 3, SIZE // 2, SIZE)
        assert abs(got["vi"] - float(want["vi"])) <= bound["vi"]
        np.testing.assert_allclose(got["bpp"], float(want["bpp"]), rtol=bound["bpp"])
        np.testing.assert_allclose(got["bpp_ori"], float(want["bpp_ori"]), rtol=1e-4)
        np.testing.assert_allclose(got["bpp_ori"], bpp_ori, rtol=1e-4)
    im_ = _rows(ranks, "im_")
    diff = np.abs(im_ - np.asarray(want["im_"]))
    assert (diff > bound["far"]).mean() <= bound["share"], f"{(diff > bound['far']).mean():.2e}"
    assert diff.max() <= bound["max"], f"im_ {diff.max():.3e} from JAX"
    assert np.abs(im_ - inputs["adapter_x"]).max() > 1e-3  # the attack moved the input


def _check_attack_f64(worlds, monkeypatch, fam):
    """The sp=2 attack in float64 against one process's: the row-sharded
    codec, its gradient and the two-phase decisions computed exactly."""
    ranks = [r["attack_f64"] for r in worlds.ranks(f"sp2_{fam}")]
    one = _one_process(cases.in_dtype(copy.deepcopy(_models(fam)[2]), torch.float64), fam,
                       worlds.inputs, torch.float64, **cases.ADAPTER_ATTACK)
    for got in ranks:
        for k in ("vi", "mse_in", "bpp_ori", "bpp", "vi_msim"):
            np.testing.assert_allclose(got[k], one[k].item(), rtol=F64_RTOL, atol=0, err_msg=k)
    np.testing.assert_allclose(_rows(ranks, "im_"), nhwc(one["im_"]), rtol=0, atol=F64_IM_ATOL)


_CHECKS = {"forward": _check_forward, "attack": _check_attack, "attack_f64": _check_attack_f64}


@pytest.mark.parametrize("fam, part", [(f, p) for f in FAMILIES for p in _CHECKS])
def test_row_sharded_family_matches_unsharded(worlds, monkeypatch, fam, part):
    """Each family's sp=2 forward, float32 attack and float64 attack (the
    checks of a family in a row, so that one family's weights are held at
    a time)."""
    _CHECKS[part](worlds, monkeypatch, fam)


def test_row_sharded_nlaic_split_attack_matches_one_process(worlds):
    """``split_eval`` on sp=2: the stage recompute gathers the non-local
    blocks' keys and values again, under the shard its forward saw."""
    one = _one_process(_models("nlaic")[2], "nlaic", worlds.inputs, **cases.ADAPTER_ATTACK,
                       split_eval=True)
    ranks = worlds.ranks("sp2_nlaic_split")
    for got in ranks:
        for k in ("vi", "mse_in", "bpp_ori", "bpp", "vi_msim"):
            np.testing.assert_allclose(got[k], one[k].item(), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_rows(ranks, "im_"), nhwc(one["im_"]), rtol=0, atol=SP_IM_ATOL)


# -- the collectives ------------------------------------------------------------


@pytest.mark.parametrize("size", [2, 4])
def test_roll_rows_matches_torch_roll(worlds, size):
    """Values and gradients of the sharded roll, NCHW (rows dim 2) and NHWC
    (rows dim 1), by +-1 and +-2 rows: at 4 ranks a block is 2 rows, so a
    roll by 2 moves whole blocks."""
    ranks = worlds.ranks("roll_rows_case", size)
    x = torch.from_numpy(worlds.inputs["roll_x"]).requires_grad_(True)
    w = torch.from_numpy(worlds.inputs["roll_w"])
    for layout, dim in (("nchw", 2), ("nhwc", 1)):
        xi = x if layout == "nchw" else x.permute(0, 2, 3, 1)
        wi = w if layout == "nchw" else w.permute(0, 2, 3, 1)
        for shift in ROLL_SHIFTS:
            y = torch.roll(xi, shift, dims=dim)
            (dx,) = torch.autograd.grad((y * wi).sum(), x)
            dx = dx if layout == "nchw" else dx.permute(0, 2, 3, 1)
            got = np.concatenate([r[(layout, shift)]["y"] for r in ranks], axis=dim)
            np.testing.assert_array_equal(got, y.detach().numpy())
            got = np.concatenate([r[(layout, shift)]["dx"] for r in ranks], axis=dim)
            np.testing.assert_allclose(got, dx.numpy(), rtol=0, atol=1e-6)


def test_shared_rows_sums_every_ranks_gradient(worlds):
    """``shared_rows``: every rank holds the whole tensor, and a rank's
    rows get the sum of every rank's gradient of them (rank r weighs the
    tensor by roll_w x (r + 1), so the sum is roll_w x 3).  The sp=2
    non-local block (queries local, keys and values gathered) against the
    block on the whole tensor: output, input and parameter gradients."""
    ranks = worlds.ranks("shared_rows_case")
    x, w = worlds.inputs["roll_x"], worlds.inputs["roll_w"]
    for r in ranks:
        np.testing.assert_array_equal(r["full"], x)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks], axis=2), 3 * w,
                               rtol=0, atol=1e-6)

    blk = NonLocalBlock(8)
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in worlds.inputs["nl_state"].items()})
    xt = torch.from_numpy(worlds.inputs["nl_x"]).requires_grad_(True)
    y = blk(xt)
    (y * torch.from_numpy(worlds.inputs["nl_w"])).sum().backward()
    np.testing.assert_allclose(np.concatenate([r["nl_y"] for r in ranks], axis=2),
                               y.detach().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["nl_dx"] for r in ranks], axis=2),
                               xt.grad.numpy(), rtol=0, atol=1e-5)
    for k, p in blk.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["nl_grads"][k], p.grad.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


# -- one process ----------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
def test_deconv_subpixel_form_matches_conv_transpose(k):
    """The stride-2 ``Deconv``'s subpixel 3x3 conv, then ``depth_to_space``
    (its row-sharded form), against ``F.conv_transpose2d``, in float64."""
    d = Deconv(6, 5, k, 2).double()
    d.reset_parameters(torch.Generator().manual_seed(k))
    x = torch.randn(2, 6, 7, 9, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = F.conv_transpose2d(x, d.weight, d.bias, 2, k // 2, 1)
        got = depth_to_space(F.conv2d(x, d.phase_weight(), d.bias.repeat(4), padding=1))
    assert got.shape == want.shape == (2, 5, 14, 18)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel, stride, rows", [
    (7, 1, (3, 3)),  # hific's head and tail
    (5, 2, (2, 1)),  # the balle transforms, the hyper analysis
    (5, 1, (2, 2)),  # the context models, invcompress's couplings
    (3, 2, (1, 0)),  # hific's and tic's downsampling, cheng2020
    (3, 1, (1, 1)),  # the subpixel convs, hific's residual blocks
    (1, 1, (0, 0)),  # pointwise convs
])
def test_halo_rows_of_each_conv(kernel, stride, rows):
    assert shard.halo_rows(kernel, stride, kernel // 2) == rows


def _one_rank_of_two():
    """A row shard of 2 ranks as rank 0 sees it, for checks that raise
    before any collective."""
    return shard.sharded(rows=shard.Axis(None, 0, 2))


def test_row_shard_rejects_misaligned_blocks():
    """A block that starts on an odd row (invcompress's squeeze) or holds
    part of a window (tic) raises, naming the layer."""
    with _one_rank_of_two(), pytest.raises(ValueError, match="squeeze2"):
        invcompress.squeeze2(torch.zeros(1, 3, 6, 8)[:, :, :5])
    blk = tic.SwinBlock(8, 2, 4, True)
    with _one_rank_of_two(), pytest.raises(ValueError, match="SwinBlock"):
        blk(torch.zeros(1, 6, 8, 8))
    with pytest.raises(ValueError, match="stride=2"), _one_rank_of_two():
        Deconv(4, 3, 3, 1)(torch.zeros(1, 4, 4, 4))
