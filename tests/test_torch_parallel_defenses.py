"""Slice 10 c-e of the port's row sharding against the JAX package on the
CPU: the row-sharded attack through the in-loop defenses (the
self-ensemble, ``batch`` and ``scan``; the bit-depth reduction; the
resize) and with ``-p`` reflect padding, on even and uneven row blocks;
recompression training on a dp and a dp x sp mesh; and the ``--adv``
inner attack on a dp x sp mesh.

The ranks run in a 2-rank and a 4-rank gloo world spawned once for the
module (their side is ``tests/torch_spmd_cases.py``), in background
threads while the tests compute the JAX side here, on the conftest's
virtual CPU devices.  Both sides take hyper q1 on the demo weights, the
``sp_x`` image (256x128) and the ``dpsp_batches`` (2 x 512x64) of
``tests/test_torch_parallel.py``, and its noise tables for the training
forward.  The ranks and the one-process runs take one torch thread with
oneDNN off.

Bounds, each with its source:
* the attacks (3 ``select`` steps, so the codec runs on every step): vi,
  mse_in, bpp_ori and bpp rtol 1e-4, atol 1e-6 against JAX's
  ``make_spatial_attack_fn`` on a 2-device mesh (one JAX run a defense,
  held by the sp=2 and the sp=4 runs) and against the port's one-process
  run (``tests/test_torch_parallel.py``'s row-sharded bounds); ``im_``
  against the one-process run at 1e-5, and against JAX's at
  ``tests/test_torch_rd_defended.py``'s bounds with oneDNN off (1e-5;
  5e-5 for the ensemble and the resize, whose paths sit ~1e-5 from a
  float64 run on either side) but for the bit-depth reduction: there
  JAX's float32 run sits 1.44e-4 from a float64 run of the port (on 105
  of the 98,304 elements past 1e-5), the port's 2.7e-6 (one process) and
  3.6e-6 (sp=2), so JAX is held at 2e-4 (at 64x64 its own test holds it at
  1e-5);
* the resize in float64, sharded against one process: every scalar
  rtol 1e-9, ``im_`` atol 1e-9 (``tests/test_torch_parallel_adapters.py``'s
  exactness check);
* uneven row shards: ``-p 32`` pads the 256 rows to 320, split 192 and 128
  at sp=2 and 128, 128, 64 and 0 at sp=4, and the ensemble's rotated
  variants have the 128 columns as rows, 64, 64, 0 and 0 at sp=4: each
  against JAX's run on an sp-device mesh (GSPMD splits the same rows
  unevenly) and one process at the attacks' float32 bounds above and, at
  sp=2 for ``-p`` and sp=4 for the ensemble, in float64 against one
  process at the resize's;
* the inner attack (10 steps, both phases): every rank takes the output
  phase in the steps the one-process run takes it; the adversarial batch
  within 1e-4 of JAX's unsharded run on the global batch and of the
  port's one-process run (``tests/test_torch_train.py``'s pixel bound);
* recompression training, 3 steps on dp=2 and on dp x sp = 2 x 2 against
  JAX's unsharded ``train_step(recompress=True)``: the bounds of
  ``tests/test_torch_parallel.py``'s training cases (step 1's loss terms,
  ``recompress_loss`` among them, rtol 1e-5; later steps 1e-3; the
  parameters within 2 x 3 x lr).
"""

import copy
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from imagecompression_adversarial_tpu.attacks import RDAttackConfig as JRDAttackConfig
from imagecompression_adversarial_tpu.attacks.rd import make_adv_example_fn as j_make_adv
from imagecompression_adversarial_tpu.parallel import spatial_shard as j_spatial_shard
from imagecompression_adversarial_tpu.train import step as j_step
from imagecompression_adversarial_tpu_torch.attacks import RDAttackConfig, make_attack_fn
from imagecompression_adversarial_tpu_torch.attacks.rd import make_adv_example_fn
from imagecompression_adversarial_tpu_torch.ops import shard
from imagecompression_adversarial_tpu_torch.train import lambda_for

import torch_spmd_cases as cases
from test_torch_parallel import (
    DPSP_ROWS, LR, NOISE, STEPS, WORLD_TIMEOUT_S, _batches, _check_training, _devices, _jax_noise,
)
from torch_parity import IM_ATOL, hyper_models, nchw, nhwc, one_torch_thread  # noqa: F401

SCENARIOS = {
    2: ["sp_bitdepth", "sp_resize", "sp_pad", "sp_ensemble_batch", "sp_ensemble_scan",
        "sp_pad_uneven", "sp_pad_uneven_f64", "train_recompress", "sp_resize_f64"],
    4: ["sp_bitdepth", "sp_resize", "sp_ensemble_batch", "sp_ensemble_batch_f64",
        "sp_pad_uneven", "adv_dpsp", "train_recompress"],
}
# im_ against JAX, by case (the docstring); against one process: IM_ATOL
WIDE_IM_ATOL = 5e-5
JAX_IM_ATOL = {"ensemble_batch": WIDE_IM_ATOL, "ensemble_scan": WIDE_IM_ATOL,
               "resize": WIDE_IM_ATOL, "bitdepth": 2e-4, "pad": IM_ATOL[False],
               "pad_uneven": IM_ATOL[False]}
F64_TOL = 1e-9
ADV_ATOL = 1e-4
SCALARS = ("vi", "mse_in", "bpp_ori", "bpp", "vi_msim")
LOG_KEYS = ("loss", "recompress_loss", "bpp_loss", "distortion", "aux_loss")


@functools.lru_cache(maxsize=1)
def _inputs():
    _, jp, _ = hyper_models()
    return {
        "params": {"hyper": jp},
        "sp_x": np.random.RandomState(3).rand(1, 256, 128, 3).astype(np.float32),
        "dpsp_batches": [b[:, :, :64] for b in _batches(STEPS, DPSP_ROWS, 1)],
        "noise": {"dpsp": NOISE["dpsp"][1]},
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = cases.StreamedWorlds(_inputs(), tmp_path_factory.mktemp("spmd_defenses"), SCENARIOS,
                             WORLD_TIMEOUT_S)
    yield w
    w.close()


def _rows(ranks, key="im_"):
    """The ranks' NHWC rows, stacked into the whole image."""
    return np.concatenate([r[key] for r in ranks], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_attack(name, sp=2):
    """JAX's row-sharded attack of ``DEFENSE_CASES[name]`` on ``sp_x``,
    on an ``sp``-device mesh, as numpy."""
    jm, jp, _ = hyper_models()
    x = _inputs()["sp_x"]
    attack = j_spatial_shard.make_spatial_attack_fn(
        jm, JRDAttackConfig(**cases.DEFENSE_CASES[name]), Mesh(_devices(sp), ("sp",)))
    return {k: np.asarray(v) for k, v in attack(jp, x).items() if k in SCALARS + ("im_",)}


def _one_process(model, name, x, dtype=torch.float32):
    """The port's attack of ``DEFENSE_CASES[name]`` on the whole image in
    this process, in ``dtype``, oneDNN off (one thread: the fixture)."""
    with torch.backends.mkldnn.flags(enabled=False):
        return make_attack_fn(model, RDAttackConfig(**cases.DEFENSE_CASES[name]))(
            nchw(x).to(dtype))


@functools.lru_cache(maxsize=None)
def _one_process_f32(name):
    res = _one_process(hyper_models()[2], name, _inputs()["sp_x"])
    return {k: float(res[k]) for k in SCALARS} | {"im_": nhwc(res["im_"])}


@pytest.mark.parametrize("name, sp", [
    ("bitdepth", 2), ("bitdepth", 4), ("resize", 2), ("resize", 4), ("pad", 2),
    ("ensemble_batch", 2), ("ensemble_scan", 2),
])
def test_row_sharded_defense_attack_matches_jax(worlds, name, sp):
    """The attack through an in-loop defense (or with ``-p 64``: the
    clean forward on the padded image's 384 rows) on sp ranks."""
    want, one = _jax_attack(name), _one_process_f32(name)
    ranks = worlds.ranks(f"sp_{name}", sp)
    for got in ranks:
        assert got["rows"] == got["x_rows"] == (1, 3, 256 // sp, 128)
        for k in SCALARS:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} vs JAX")
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k} vs one process")
    im_ = _rows(ranks)
    np.testing.assert_allclose(im_, want["im_"], rtol=0, atol=JAX_IM_ATOL[name])
    np.testing.assert_allclose(im_, one["im_"], rtol=0, atol=IM_ATOL[False])
    assert np.abs(im_ - _inputs()["sp_x"]).max() > 1e-3  # the attack moved the input


def test_row_sharded_resize_equals_one_process_in_float64(worlds):
    """The sharded resize (the gathered image, the whole image's resize,
    this rank's rows, the backward's sum over the ranks) against one
    process, both in float64."""
    model = cases.in_dtype(copy.deepcopy(hyper_models()[2]), torch.float64)
    one = _one_process(model, "resize", _inputs()["sp_x"], torch.float64)
    ranks = worlds.ranks("sp_resize_f64", 2)
    for got in ranks:
        for k in SCALARS:
            np.testing.assert_allclose(got[k], one[k].item(), rtol=F64_TOL, atol=F64_TOL,
                                       err_msg=k)
    np.testing.assert_allclose(_rows(ranks), nhwc(one["im_"]), rtol=0, atol=F64_TOL)


@functools.lru_cache(maxsize=None)
def _one_process_f64(name):
    model = cases.in_dtype(copy.deepcopy(hyper_models()[2]), torch.float64)
    res = _one_process(model, name, _inputs()["sp_x"], torch.float64)
    return {k: res[k].item() for k in SCALARS} | {"im_": nhwc(res["im_"])}


def _check_one_process(ranks, name, sp, dtype):
    """Every rank's scalars and the ranks' rows of ``im_`` against the
    one-process run, at the float32 or float64 bounds of the docstring;
    in float32 also against JAX's run of the case on an sp-device mesh,
    where GSPMD splits the same rows unevenly, at the bounds of
    ``test_row_sharded_defense_attack_matches_jax``."""
    one = _one_process_f32(name) if dtype == "f32" else _one_process_f64(name)
    want = _jax_attack(name, sp) if dtype == "f32" else None
    rtol, atol, im_atol = (1e-4, 1e-6, IM_ATOL[False]) if dtype == "f32" else (F64_TOL,) * 3
    for got in ranks:
        assert got["rows"] == got["x_rows"] == (1, 3, 256 // sp, 128)
        for k in SCALARS:
            np.testing.assert_allclose(got[k], one[k], rtol=rtol, atol=atol,
                                       err_msg=f"{k} vs one process")
            if want is not None:
                np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, atol=1e-6,
                                           err_msg=f"{k} vs JAX")
    im_ = _rows(ranks)
    np.testing.assert_allclose(im_, one["im_"], rtol=0, atol=im_atol)
    if want is not None:
        np.testing.assert_allclose(im_, want["im_"], rtol=0, atol=JAX_IM_ATOL[name])
    assert np.abs(im_ - _inputs()["sp_x"]).max() > 1e-3  # the attack moved the input


def test_row_sharded_pad_rejects_an_unsplittable_padded_height(worlds):
    """``-p 32`` once raised at sp=2 (320 padded rows do not divide by
    128); now the padded image splits 192 and 128, and the run equals JAX's
    on 2 devices and one process in float32, and one process in float64."""
    _check_one_process(worlds.ranks("sp_pad_uneven", 2), "pad_uneven", 2, "f32")
    _check_one_process(worlds.ranks("sp_pad_uneven_f64", 2), "pad_uneven", 2, "f64")


def test_row_sharded_ensemble_rejects_a_narrow_image(worlds):
    """The ensemble at sp=4 once raised (the rotated variants' 128 rows
    make blocks of 32); now they split 64, 64, 0 and 0, two ranks run the
    codec on empty blocks, and the run equals JAX's on 4 devices and one
    process in float32, and one process in float64."""
    _check_one_process(worlds.ranks("sp_ensemble_batch", 4), "ensemble_batch", 4, "f32")
    _check_one_process(worlds.ranks("sp_ensemble_batch_f64", 4), "ensemble_batch", 4, "f64")


def test_row_sharded_uneven_pad_with_an_empty_rank(worlds):
    """``-p 32`` at sp=4: the padded 320 rows split 128, 128, 64 and 0;
    held to JAX's run on 4 devices and to one process."""
    _check_one_process(worlds.ranks("sp_pad_uneven", 4), "pad_uneven", 4, "f32")


@pytest.mark.parametrize("total, n, blocks", [
    (256, 2, [128, 128]), (320, 2, [192, 128]), (320, 4, [128, 128, 64, 0]),
    (128, 4, [64, 64, 0, 0]), (768, 4, [192, 192, 192, 192]), (640, 4, [192, 192, 192, 64]),
])
def test_row_blocks_keep_every_interior_boundary_on_64_rows(total, n, blocks):
    assert shard.row_blocks(total, n) == blocks


def test_even_row_blocks_take_their_heights_without_a_gather():
    """Under ``sharded(..., even_rows=True)`` every block's height is this
    rank's (the axis has no process group, so a gather would raise), and
    ``own_rows`` raises where it would split a total unevenly."""
    axis = shard.Axis(None, 1, 2)
    y = torch.zeros(2, 3, 64, 8)
    with shard.sharded(rows=axis, even_rows=True):
        assert shard.block_heights(64, axis, y) == [64, 64]
        assert shard.row_offset(y) == 64
        drawn = shard.local_draw(y, lambda full: torch.arange(full.numel()).view(full.shape))
        np.testing.assert_array_equal(drawn.numpy(),
                                      np.arange(2 * 3 * 128 * 8).reshape(2, 3, 128, 8)[:, :, 64:])
        whole = torch.arange(256.0).view(1, 1, 256, 1)
        np.testing.assert_array_equal(shard.own_rows(whole).flatten().numpy(), np.arange(128, 256))
        with pytest.raises(ValueError, match=re.escape("320 rows split [192, 128]")):
            shard.own_rows(torch.zeros(1, 1, 320, 1))


def test_dp_sp_adv_example_matches_jax(worlds):
    """The inner attack on dp x sp = 2 x 2 (a rank holds one image's half
    rows): one phase for every rank each step, the global batch's."""
    jm, jp, model = hyper_models()
    batch = worlds.inputs["dpsp_batches"][0]
    cfg = dict(steps=cases.BRANCH_STEPS)
    want = np.asarray(jax.jit(j_make_adv(jm, JRDAttackConfig(**cfg)))(
        jp, jnp.asarray(batch), jnp.float32(cases.DPSP_ADV_THRESHOLD)))
    calls = []
    hook = model.g_a.register_forward_hook(lambda *_: calls.append(1))
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            one = nhwc(make_adv_example_fn(model, RDAttackConfig(**cfg))(
                nchw(batch), cases.DPSP_ADV_THRESHOLD))
    finally:
        hook.remove()
    ranks = worlds.ranks("adv_dpsp", 4)
    steps = len(calls) - 1
    assert 0 < steps < cases.BRANCH_STEPS  # both phases
    assert [r["output_steps"] for r in ranks] == [steps] * 4
    # rank = 2 x dp index + sp index
    got = np.concatenate([_rows(ranks[2 * d:2 * d + 2], "im") for d in range(2)], axis=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ADV_ATOL)
    np.testing.assert_allclose(got, one, rtol=0, atol=ADV_ATOL)


@functools.lru_cache(maxsize=1)
def _jax_recompress_training():
    """JAX's unsharded ``train_step(recompress=True)``, one step a batch of
    ``dpsp_batches``, under the ``dpsp`` noise tables: (None, the logs, the
    parameters)."""
    jm, jp, _ = hyper_models()
    state, train_step = j_step.create_train_state(jm, jp)
    lmbda = lambda_for("mse", 1)
    fn = jax.jit(lambda s, b, r: train_step(s, b, r, LR, lmbda, "mse", recompress=True))
    logs = []
    with pytest.MonkeyPatch.context() as mp:
        _jax_noise(mp, "dpsp")
        for i, b in enumerate(_inputs()["dpsp_batches"]):
            state, out = fn(state, jnp.asarray(b), jax.random.PRNGKey(i))
            logs.append({k: float(v) for k, v in out.items()})
    return None, logs, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("size", [2, 4], ids=["dp2", "dp2xsp2"])
def test_recompress_training_on_a_mesh_matches_jax(worlds, size):
    _check_training(worlds.ranks("train_recompress", size), "hyper", *_jax_recompress_training(),
                    keys=LOG_KEYS)
