"""CLI: export the params of a training checkpoint to a compact flax
msgpack demo checkpoint, float16 unless ``--fp32`` (port of
``scripts/export_ckpt.py``)::

    python -m imagecompression_adversarial_tpu_torch.cli.export_ckpt \\
        ckpts/adv/hyper-0.013-mse-0.0001-300 -m hyper -q 4 \\
        -o ckpts/demo/hyper-q4-mse-advtuned2000.msgpack [--fp32]

``ckpt_dir`` is a step or ``best_loss`` directory, or a training directory
whose ``best_loss/`` is then taken.  It reads both trainers' steps: an
orbax item of the JAX trainer (``train/orbax.py``) and this port's
``checkpoint.pt`` (``train/checkpoint.py``, its params mapped to flax
names by ``io/weights.py::codec_to_jax``).  Either is checked against the
``-m``/``-q`` codec's parameters.  The file holds the bytes of the JAX
script's ``flax.serialization.to_bytes``: every map's keys sorted, as
``jax.tree_util`` rebuilds them, and each leaf cast with numpy's
round-to-nearest-even, as ``jnp.asarray(a, float16)`` casts.  Both
loaders read it (``io/weights.py::load_checkpoint`` and JAX's
``runtime.load_model``).  The conversion runs on the host; it takes no
device.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..io.weights import TRAIN_CHECKPOINT, codec_to_jax, params_from_jax, write_msgpack
from ..models.registry import init_model
from ..train import orbax

BEST = "best_loss"


def _sorted_tree(node: Any, dtype: np.dtype) -> Any:
    if isinstance(node, dict):
        return {str(k): _sorted_tree(node[k], dtype) for k in sorted(node, key=str)}
    return np.asarray(node).astype(dtype)


def read_params(path: str, model: str, quality: int) -> Tuple[Dict[str, Any], int, Any]:
    """(flax parameter tree, step, eval loss) of the checkpoint at
    ``path``; the tree must load into the ``model``/``quality`` codec."""
    codec = init_model(model, quality)
    pt = path if path.endswith(".pt") else os.path.join(path, TRAIN_CHECKPOINT)
    if os.path.isfile(pt):
        payload = torch.load(pt, map_location="cpu", weights_only=True)
        codec.load_state_dict(payload["state"]["params"], strict=True)
        return codec_to_jax(codec, model), int(payload["state"]["step"]), \
            payload["extra"].get("loss")
    tree, _ = orbax.read_item(path)
    params = tree["state"]["params"]
    codec.load_state_dict(params_from_jax(params, model), strict=True)
    return params, int(tree["state"]["step"]), tree.get("extra", {}).get("loss")


def export(ckpt_dir: str, model: str, quality: int, out: str, fp32: bool = False) -> str:
    """Write the demo checkpoint and return JAX's report line."""
    path = ckpt_dir
    if os.path.isdir(os.path.join(path, BEST)):
        path = os.path.join(path, BEST)
    params, step, loss = read_params(path, model, quality)
    write_msgpack(out, _sorted_tree(params, np.dtype(np.float32 if fp32 else np.float16)))
    size_mb = os.path.getsize(out) / 1e6
    return (f"exported {out} ({size_mb:.1f} MB, {'fp32' if fp32 else 'fp16'}) "
            f"from step {step} loss {loss}")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="export_ckpt", description=__doc__.splitlines()[0])
    ap.add_argument("ckpt_dir", help="training ckpt dir (uses its best_loss/ "
                                     "if present) or a best_loss dir itself")
    ap.add_argument("-m", dest="model", required=True)
    ap.add_argument("-q", dest="quality", type=int, required=True)
    ap.add_argument("-o", dest="out", required=True)
    ap.add_argument("--fp32", action="store_true",
                    help="store float32 (default: float16)")
    args = ap.parse_args(argv)
    line = export(args.ckpt_dir, args.model, args.quality, args.out, args.fp32)
    print(line)
    return line


if __name__ == "__main__":
    main()
