"""The read half of ``imagecompression_adversarial_tpu/train/checkpoint.py``:
an orbax ``StandardSave`` item of the JAX trainer, read into numpy and
mapped onto the port's ``TrainState``.

* ``item_dir`` finds the item: a manager step's ``default/`` or a
  ``best_loss`` directory (JAX's ``StandardCheckpointer``), each holding
  ``_METADATA``.
* ``read_item`` walks ``_METADATA``'s ``tree_metadata`` into nested dicts:
  arrays from the item's OCDBT store (``io/ocdbt.py``) as zarr v2 arrays
  (``io/zarr.py``), each named by its key path joined with dots; ``scalar``
  leaves as Python numbers; the empty leaves orbax records for optax's
  masked partitions and empty states as None.
* ``train_state_dict`` maps the tree onto a ``TrainState.state_dict()``
  payload.  Params go through ``io/weights.py::params_from_jax``.  The
  main Adam (``opt_state.inner_states.main.inner_state.1``) and the aux
  Adam (``aux_opt_state.inner_states.aux.inner_state.0``) give each
  parameter of their group ``exp_avg`` and ``exp_avg_sq`` from ``mu`` and
  ``nu`` through the same per-leaf layout change, checked to be a pure
  permutation of the elements, and ``step`` from optax's ``count``.  The
  leaves ``multi_transform`` masks out of a partition are skipped.  The
  result must have exactly the keys and shapes of the state it goes into.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..io.ocdbt import OcdbtStore
from ..io.weights import params_from_jax
from ..io.zarr import read_array
from .step import TrainState

METADATA = "_METADATA"
#: the file orbax writes into every step directory it has committed
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
# where each optax Adam state sits in the JAX trainer's optimizer states
# (``imagecompression_adversarial_tpu/train/step.py::make_optimizers``):
# multi_transform's partition, then the chain index of scale_by_adam
ADAM_PATHS = {"opt_state": ("main", "1"), "aux_opt_state": ("aux", "0")}


def item_dir(path: str) -> str:
    """The orbax item under ``path``: ``path`` itself where it holds
    ``_METADATA`` (a ``best_loss`` directory), else its ``default/``."""
    for d in (path, os.path.join(path, "default")):
        if os.path.isfile(os.path.join(d, METADATA)):
            return d
    raise FileNotFoundError(f"{path} holds no orbax item ({METADATA} in it or in default/)")


def read_item(path: str) -> Tuple[Dict[str, Any], int]:
    """(the item's tree, bytes read) of the orbax item at or under
    ``path``."""
    d = item_dir(path)
    with open(os.path.join(d, METADATA)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{d}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')}: this reader reads OCDBT with zarr v2")
    store = OcdbtStore(d)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            value = None
        elif kind in ("np.ndarray", "jax.Array", "scalar"):
            value = read_array(store, ".".join(keys))
            if kind == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{d}: leaf {'.'.join(keys)} has value type {kind!r}")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree, store.bytes_read


def _leaves(node: Any, path: Tuple[str, ...] = ()):
    """(path, value) of every leaf of a nested dict, None leaves included."""
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _leaves(child, path + (key,))
    else:
        yield path, node


def _tree(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def moments_from_jax(tree: Dict[str, Any], arch: str) -> Dict[str, torch.Tensor]:
    """A moment tree (optax's ``mu`` or ``nu``; None where masked) in the
    port's parameter names and layouts: ``params_from_jax`` of its arrays,
    after checking, leaf by leaf, that the layout change is a permutation
    of the elements (transposes and reshapes), as moments need."""
    arrays = [(p, v) for p, v in _leaves(tree) if v is not None]
    for p, v in arrays:
        if v.size >= 2**24:  # float32 holds the indices below exactly
            raise ValueError(f"{'/'.join(p)}: {v.size} elements, too many to check its layout")
    moved = params_from_jax(_tree(arrays), arch)
    index = params_from_jax(_tree((p, np.arange(v.size, dtype=np.float32).reshape(v.shape))
                                  for p, v in arrays), arch)
    for name, idx in index.items():
        idx = idx.reshape(-1).long()
        if not torch.equal(idx.sort().values, torch.arange(idx.numel())):
            raise ValueError(f"{name}: the flax layout change is not a permutation")
    return moved


def _adam(tree: Dict[str, Any], opt: torch.optim.Adam, names: Dict[int, str],
          arch: str, where: str) -> dict:
    """One torch Adam's state_dict from an optax ``ScaleByAdamState`` tree
    (``count``, ``mu``, ``nu``); ``names`` maps each index of the Adam's
    group to its parameter's port name."""
    mu, nu = moments_from_jax(tree["mu"], arch), moments_from_jax(tree["nu"], arch)
    want = set(names.values())
    for label, moments in (("mu", mu), ("nu", nu)):
        if set(moments) != want:
            raise ValueError(
                f"{where}.{label}: moments for {sorted(set(moments) - want)} outside the "
                f"optimizer's group, none for {sorted(want - set(moments))}")
    step = torch.tensor(float(np.asarray(tree["count"])), dtype=torch.float32)
    fresh = opt.state_dict()
    return {
        "state": {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in names.items()},
        "param_groups": fresh["param_groups"],
    }


def train_state_dict(tree: Dict[str, Any], state: TrainState, arch: str) -> dict:
    """The ``TrainState.state_dict()`` payload of an orbax item's tree,
    checked to have exactly the keys and shapes of ``state``'s."""
    s = tree["state"]
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    payload = {"params": params_from_jax(s["params"], arch), "step": int(np.asarray(s["step"]))}
    for key, opt in (("opt_state", state.opt), ("aux_opt_state", state.aux_opt)):
        part, index = ADAM_PATHS[key]
        group = {i: name_of[id(p)] for i, p in enumerate(opt.param_groups[0]["params"])}
        payload[key] = _adam(s[key]["inner_states"][part]["inner_state"][index], opt, group,
                             arch, f"state.{key}")
    check_like(payload, state)
    return payload


def _shapes(payload: dict, state: TrainState) -> Dict[str, Tuple[int, ...]]:
    """The shape of every tensor of a state_dict payload, by a path that
    names each optimizer entry's parameter."""
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"params.{k}": tuple(v.shape) for k, v in payload["params"].items()}
    for key, opt in (("opt_state", state.opt), ("aux_opt_state", state.aux_opt)):
        group = [name_of[id(p)] for p in opt.param_groups[0]["params"]]
        for i, entry in payload[key]["state"].items():
            for name, v in entry.items():
                param = group[i] if 0 <= i < len(group) else f"#{i}"
                out[f"{key}.{param}.{name}"] = tuple(v.shape)
    return out


def check_like(payload: dict, state: TrainState) -> None:
    """Raise, naming the first difference (params first), unless
    ``payload`` has exactly the tensors of ``state.state_dict()`` once the
    Adams have stepped: every parameter, and ``step``, ``exp_avg`` and
    ``exp_avg_sq`` for each parameter of each Adam, each of its shape."""
    fresh = {"params": state.model.state_dict()}
    for key, opt in (("opt_state", state.opt), ("aux_opt_state", state.aux_opt)):
        fresh[key] = {"state": {i: {"step": torch.zeros(()), "exp_avg": p, "exp_avg_sq": p}
                                for i, p in enumerate(opt.param_groups[0]["params"])}}
    want, got = _shapes(fresh, state), _shapes(payload, state)
    for path in list(want) + [p for p in got if p not in want]:
        if path not in got:
            raise ValueError(f"the restored state has no {path}")
        if path not in want:
            raise ValueError(f"the restored state has {path}, which the model does not")
        if got[path] != want[path]:
            raise ValueError(f"{path}: shape {list(got[path])} restored, {list(want[path])} "
                             "in the model")


def restore(path: str, state: TrainState, arch: str) -> Dict[str, Any]:
    """Load the orbax item at or under ``path`` into ``state`` in place;
    returns its ``extra``."""
    tree, _ = read_item(path)
    state.load_state_dict(train_state_dict(tree, state, arch))
    return dict(tree.get("extra", {}))


def is_orbax_step(path: str) -> bool:
    """Whether ``path`` is a step directory orbax committed."""
    return os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))
