"""The port's reader of the JAX trainer's orbax checkpoints (``io/zstd.py``,
``io/ocdbt.py``, ``io/zarr.py``, ``train/orbax.py``) and the resume
through ``train/checkpoint.py`` and ``train/trainer.py``, against the JAX
package, orbax and tensorstore on the CPU.

* Every leaf of the committed tree's step 2000 and of its ``best_loss``
  (286 each: 171 arrays and scalars, and 115 empty leaves of optax's masked
  partitions and empty states) equals JAX's own restore with a hyper q4
  template, bit for bit; the fingerprint ``chip_smoke.py`` phase 20a holds
  the card to is the one of JAX's restore.
* The restored ``TrainState``: params ``params_from_jax`` of JAX's, each
  Adam moment the same relayout of JAX's ``mu`` and ``nu`` (and, for a
  conv and a transposed conv, the explicit transposes), each ``step`` its
  optax ``count``.  A q1 template restores (hyper q1-5 share their
  widths); a q6 one raises, naming its first mismatched parameter.
* The OCDBT and zarr readers against tensorstore's reads of stores it
  writes with small nodes (interior B-tree nodes, a version tree), values
  inline and by reference, multi-chunk, F-order and 0-d arrays.
* One resumed run on each side: JAX's ``train`` and the port's, each on its
  own copy of step 2000 (``--adv -steps 3``, batch 1, 64x64 crops, to step
  2001) with the same injected noise.  Losses within rtol 1e-3, params at
  ``tests/test_torch_trainer.py``'s bounds, once at its lr and once at the
  restored one (1.5625e-7, which a wrong moment layout would break), the
  moments of both Adams after the step within MOMENT_REL of each tensor's
  largest element, and the same directories left.
* No fallback: a missing libzstd raises naming it; a truncated or
  corrupted node, a truncated or missing data file, a missing chunk and
  another compressor raise.
"""

import functools
import os
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import chip_smoke
from imagecompression_adversarial_tpu.config import Config as JConfig
from imagecompression_adversarial_tpu.models import init_model as j_init_model
from imagecompression_adversarial_tpu.models import init_params as j_init_params
from imagecompression_adversarial_tpu.train import step as j_step
from imagecompression_adversarial_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from imagecompression_adversarial_tpu.train.trainer import train as j_train
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.io import ocdbt, zarr, zstd
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.train import orbax
from imagecompression_adversarial_tpu_torch.train.checkpoint import CheckpointManager
from imagecompression_adversarial_tpu_torch.train.step import create_train_state
from imagecompression_adversarial_tpu_torch.train.trainer import train
from test_torch_trainer import LOSS_RTOL, _params_close
from torch_parity import REPO, one_torch_thread, onednn, same_noise  # noqa: F401  (fixtures)

TREE = REPO / "ckpts" / "adv" / "hyper-0.013-mse-0.0001-300"
STEP = 2000
N_LEAVES = 286
# the moments of both Adams one step after the resume, port against JAX:
# 0.1 of the new gradient enters mu (0.001 of its square nu), and the two
# sides' gradients differ by float32 rounding of the step's forward and
# backward (measured: main Adam 4.5e-6 for mu and 2.1e-7 for nu, the aux
# Adam's quantiles 1.6e-7 and 7.5e-8, the params at most 3.7e-9 apart)
MOMENT_REL = 1e-4


@pytest.fixture(scope="module")
def tree_copy(tmp_path_factory):
    """A copy of step 2000 and ``best_loss``, for JAX's manager to read."""
    root = tmp_path_factory.mktemp("orbax_tree")
    for name in (str(STEP), "best_loss"):
        shutil.copytree(TREE / name, root / name)
    return root


@functools.lru_cache(maxsize=None)
def jax_template(quality: int = 4):
    """JAX's TrainState of hyper ``quality`` as shapes and dtypes."""
    jm = j_init_model("hyper", quality)
    return jax.eval_shape(lambda k: j_step.create_train_state(jm, j_init_params(jm, k))[0],
                          jax.random.PRNGKey(0))


def _payload(state, extra):
    return {"state": {"params": state.params, "opt_state": state.opt_state,
                      "aux_opt_state": state.aux_opt_state, "step": state.step},
            "extra": extra}


def jax_restore(root, item: str) -> dict:
    """JAX's restore of a step (its manager) or of ``best_loss`` (its
    ``StandardCheckpointer``, as ``train/checkpoint.py`` writes it)."""
    template = jax_template()
    if item == "best_loss":
        tmpl = _payload(template, {"epoch": 0, "loss": 0.0, "lr": 0.0})
        return ocp.StandardCheckpointer().restore(str(root / item), tmpl)
    return _payload(*JCheckpoints(str(root)).restore(template, step=int(item)))


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jax_leaves(tree) -> dict:
    return {tuple(_key(k) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {p: v for key, child in tree.items()
                for p, v in port_leaves(child, path + (key,)).items()}
    return {path: tree}


def nested(leaves: dict) -> dict:
    out = {}
    for path, value in leaves.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


@pytest.mark.parametrize("item", [str(STEP), "best_loss"])
def test_every_leaf_equals_jax_restore(tree_copy, item):
    tree, nbytes = orbax.read_item(str(TREE / item))
    got = port_leaves(tree)
    want = {p: (np.asarray(v) if hasattr(v, "shape") else v)
            for p, v in jax_leaves(jax_restore(tree_copy, item)).items()}
    assert len(got) == N_LEAVES and len(want) == 171 and nbytes > 50e6
    assert {p for p, v in got.items() if v is not None} == set(want)
    for path, value in want.items():
        mine = got[path]
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype and mine.shape == value.shape, path
            assert mine.tobytes() == value.tobytes(), path
        else:
            assert type(mine) is type(value) and mine == value, path
    fp = chip_smoke.orbax_fingerprint(tree)
    assert fp == chip_smoke.orbax_fingerprint(nested(want))
    if item == str(STEP):
        assert fp == chip_smoke.ORBAX_FINGERPRINT


def _q_state(quality: int):
    return create_train_state(init_model("hyper", quality, 0).requires_grad_(True), 1e-4)


def test_restored_state_maps_jax_params_and_moments(tree_copy):
    want = jax_restore(tree_copy, str(STEP))["state"]
    want = jax.tree_util.tree_map(np.asarray, want)
    state = _q_state(4)
    extra = CheckpointManager(str(TREE), "hyper").restore(state, step=STEP)
    assert extra == {"epoch": 0, "loss": 7.590668201446533, "lr": 1.5625e-07}
    assert state.step == STEP
    params = state.model.state_dict()
    jparams = params_from_jax(want["params"], "hyper")
    assert params.keys() == jparams.keys()
    assert all(torch.equal(params[k], jparams[k]) for k in params)
    names = {id(p): n for n, p in state.model.named_parameters()}
    for opt, adam in ((state.opt, want["opt_state"].inner_states["main"].inner_state[1]),
                      (state.aux_opt, want["aux_opt_state"].inner_states["aux"].inner_state[0])):
        mu, nu = (params_from_jax(nested(jax_leaves(t)), "hyper") for t in (adam.mu, adam.nu))
        entries = opt.state_dict()["state"]
        group = [names[id(p)] for p in opt.param_groups[0]["params"]]
        assert sorted(group) == sorted(mu) == sorted(nu) and len(entries) == len(group)
        for i, name in enumerate(group):
            assert torch.equal(entries[i]["exp_avg"], mu[name]), name
            assert torch.equal(entries[i]["exp_avg_sq"], nu[name]), name
            assert float(entries[i]["step"]) == int(adam.count) == STEP
    assert [names[id(p)] for p in state.aux_opt.param_groups[0]["params"]] == [
        "entropy_bottleneck.quantiles"]
    main = state.opt.state_dict()["state"]
    group = [names[id(p)] for p in state.opt.param_groups[0]["params"]]
    jmu = want["opt_state"].inner_states["main"].inner_state[1].mu
    for name, kernel, perm in (("g_a.0.weight", jmu["g_a_0"]["kernel"], (3, 2, 0, 1)),
                               ("g_s.0.weight", jmu["g_s_0"]["kernel"], (2, 3, 0, 1))):
        assert np.array_equal(main[group.index(name)]["exp_avg"].numpy(),
                              kernel.transpose(perm)), name


def test_template_widths_must_match():
    q1 = _q_state(1)
    assert orbax.restore(str(TREE / str(STEP)), q1, "hyper")["epoch"] == 0
    with pytest.raises(ValueError, match=r"params\.g_a\.0\.weight: shape \[128, 3, 5, 5\] "
                                         r"restored, \[192, 3, 5, 5\]"):
        orbax.restore(str(TREE / str(STEP)), _q_state(6), "hyper")


def test_ocdbt_and_zarr_read_what_tensorstore_wrote(tmp_path):
    """Small nodes (interior B-tree nodes, a version tree over 12 commits),
    values inline and by reference, multi-chunk, F-order and 0-d arrays."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 1}}
    rng = np.random.RandomState(0)
    arrays = {"a": (rng.rand(7, 5, 3).astype("<f4"), [3, 2, 2], "C"),
              "b": (rng.randint(-9, 9, (10, 4)).astype("<i4"), [4, 4], "F"),
              "c": (np.array(3.5, "<f8"), [], "C"),
              "d": (rng.rand(6).astype(">f4"), [6], "C")}
    for name, (arr, chunks, order) in arrays.items():
        ts.open({"driver": "zarr", "kvstore": dict(base, path=name), "create": True,
                 "metadata": {"shape": list(arr.shape), "chunks": chunks, "dtype": arr.dtype.str,
                              "order": order, "compressor": {"id": "zstd", "level": 1}}},
                ).result().write(arr).result()
    kv = ts.KvStore.open(base).result()
    for i in range(8):
        kv[f"k{i:02d}"] = bytes(rng.randint(0, 256, 5 + 7 * i).astype(np.uint8))
    store = ocdbt.OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert store.keys() == sorted(k.decode() for k in keys) and len(keys) == 35
    assert all(store.read(k.decode()) == kv.read(k).result().value for k in keys)
    for name, (arr, _, _) in arrays.items():
        got = zarr.read_array(store, name)
        assert got.shape == arr.shape and got.dtype == arr.dtype.newbyteorder("=")
        assert np.array_equal(got, arr), name
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


def test_both_levels_of_the_committed_tree_agree():
    root = ocdbt.OcdbtStore(str(TREE / str(STEP) / "default"))
    inner = ocdbt.OcdbtStore(str(TREE / str(STEP) / "default" / "ocdbt.process_0"))
    assert root.keys() == inner.keys() and len(root.keys()) == 342
    assert all(root.read(k) == inner.read(k) for k in root.keys())


def test_missing_libzstd_raises_naming_it(monkeypatch):
    zstd.library.cache_clear()
    monkeypatch.setattr("ctypes.util.find_library", lambda name: None)
    try:
        with pytest.raises(OSError, match="libzstd"):
            orbax.read_item(str(TREE / str(STEP)))
    finally:
        zstd.library.cache_clear()


def _copy_item(tmp_path):
    item = tmp_path / "default"
    shutil.copytree(TREE / str(STEP) / "default", item)
    return item


_ROOT_NODE = "d/3208ead3b653195f04cd1c4c34c19960"
_VALUES = "ocdbt.process_0/d/abd7ff67acb076792d28c5494107137f"


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip(path, offset=200):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("damage, match", [
    (lambda d: _truncate(d / _ROOT_NODE), _ROOT_NODE[2:] + ": truncated"),
    (lambda d: _flip(d / _ROOT_NODE), "checksum mismatch"),
    (lambda d: _flip(d / "manifest.ocdbt", 1), "not an OCDBT manifest"),
    (lambda d: _truncate(d / _VALUES), _VALUES[-32:] + ": truncated"),
    (lambda d: os.remove(d / _VALUES), "OCDBT file missing"),
], ids=["truncated node", "corrupt node", "bad magic", "truncated data file",
        "missing data file"])
def test_damaged_tree_raises(tmp_path, damage, match):
    item = _copy_item(tmp_path)
    damage(item)
    with pytest.raises((ValueError, FileNotFoundError), match=match):
        orbax.read_item(str(item))


def _zarr_store(tmp_path, compressor, fill):
    """One float32 (4, 4) array in 2x2 chunks, the first chunk all
    ``fill`` (so tensorstore, writing the fill value as absent, skips it)."""
    spec = {"driver": "zarr", "create": True,
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}", "path": "x"},
            "metadata": {"shape": [4, 4], "chunks": [2, 2], "dtype": "<f4",
                         "compressor": compressor, "fill_value": fill}}
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    arr[:2, :2] = fill
    ts.open(spec).result().write(arr).result()
    return ocdbt.OcdbtStore(str(tmp_path))


@pytest.mark.parametrize("compressor, fill, match", [
    ({"id": "zstd", "level": 1}, 0.0, r"chunk x/0\.0 is missing"),
    ({"id": "zlib", "level": 1}, 1.5, "compressor .*zlib"),
], ids=["missing chunk", "zlib"])
def test_zarr_refuses(tmp_path, compressor, fill, match):
    with pytest.raises(ValueError, match=match):
        zarr.read_array(_zarr_store(tmp_path, compressor, fill), "x")


def _resume_dir(root):
    """``root`` holding a copy of step 2000 where ``--adv -steps 3`` at q4
    keeps its checkpoints."""
    ckpts = root / "ckpts" / "adv" / "hyper-0.013-mse-0.0001-3"
    shutil.copytree(TREE / str(STEP), ckpts / str(STEP))
    return root


def test_resumed_adv_run_matches_jax(tmp_path, monkeypatch, same_noise, capsys):
    j_cfg = JConfig(model="hyper", quality=4, metric="mse", adv=True, steps=3, noise=1e-4,
                    batch_size=1)
    cfg = Config(device="cpu", model="hyper", quality=4, metric="mse", adv=True, steps=3,
                 noise=1e-4, batch_size=1)
    monkeypatch.chdir(_resume_dir(tmp_path / "jax"))
    want = j_train(j_cfg, max_steps=STEP + 1, crop=64)
    jstate, jextra = JCheckpoints(want["ckpt_dir"]).restore(jax_template(), step=STEP + 1)
    monkeypatch.chdir(_resume_dir(tmp_path / "port"))
    with onednn(False):
        got = train(cfg, max_steps=STEP + 1, crop=64)
    assert f"resume training from epoch 1 (step {STEP})" in capsys.readouterr().out
    assert got["steps"] == want["steps"] == STEP + 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["best_loss"], want["best_loss"], rtol=LOSS_RTOL)
    jparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), "hyper")
    params = got["state"].model.state_dict()
    _params_close(params, jparams, 1)
    _params_close(params, jparams, 1, lr=1.5625e-07)
    state = got["state"]
    names = {id(p): n for n, p in state.model.named_parameters()}
    for adam, opt in ((jstate.opt_state.inner_states["main"].inner_state[1], state.opt),
                      (jstate.aux_opt_state.inner_states["aux"].inner_state[0], state.aux_opt)):
        for label, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moments = orbax.moments_from_jax(
                nested({p: np.asarray(v) for p, v in jax_leaves(getattr(adam, label)).items()}),
                "hyper")
            for p in opt.param_groups[0]["params"]:
                mine, theirs = opt.state[p][key], moments[names[id(p)]]
                rel = float((mine - theirs).abs().max() / theirs.abs().max())
                assert rel <= MOMENT_REL, (names[id(p)], key, rel)
    assert int(jstate.step) == state.step == STEP + 1
    assert sorted(os.listdir(got["ckpt_dir"])) == sorted(os.listdir(want["ckpt_dir"])) == [
        str(STEP), str(STEP + 1), "best_loss"]
    extra = CheckpointManager(got["ckpt_dir"], "hyper").restore(_q_state(4), step=STEP + 1)
    assert (extra["epoch"], extra["lr"]) == (jextra["epoch"], jextra["lr"]) == (0, 1.5625e-07)
    np.testing.assert_allclose(extra["loss"], jextra["loss"], rtol=LOSS_RTOL)
