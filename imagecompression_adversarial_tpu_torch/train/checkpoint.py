"""Checkpoints of the training state (port of
``imagecompression_adversarial_tpu/train/checkpoint.py``, which uses orbax).

The directory scheme is the JAX package's:
``./ckpts/{anchor|adv|recompress}/{model}-{lambda}-{metric}[...]`` under
the working directory, one subdirectory a step and a ``best_loss`` copy.

* The port writes one ``checkpoint.pt`` (``torch.save``) a step: params,
  both optimizer states, the step and ``extra`` (epoch, eval loss, lr).
* It restores a step of either format: its own ``checkpoint.pt``, or an
  orbax step of the JAX trainer (``_CHECKPOINT_METADATA`` and the item in
  ``default/``), read by ``train/orbax.py`` without JAX.  So a run resumes
  where the JAX trainer stopped.  A step directory with neither raises,
  naming what it holds.
* Saves keep JAX's rules: the newest ``max_to_keep`` step numbers of both
  formats are kept and older step directories removed whole, and a new
  best replaces ``best_loss`` whole.  The port never writes into an orbax
  directory, and it never removes a step directory of neither format.
  JAX's orbax manager does not read the port's ``checkpoint.pt`` steps.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..io.weights import TRAIN_CHECKPOINT
from . import orbax
from .step import TrainState

FILENAME = TRAIN_CHECKPOINT
BEST = "best_loss"


def ckpt_dir_for(cfg, lamb: float) -> str:
    """The JAX package's directory scheme, as an absolute path."""
    if lamb in (100, 1):
        model_dir = f"{cfg.model}-Inf-{cfg.metric}"
    else:
        model_dir = f"{cfg.model}-{lamb}-{cfg.metric}"
    if cfg.adv:
        model_dir += f"-{cfg.noise}-{cfg.steps}"
        return os.path.abspath(f"./ckpts/adv/{model_dir}")
    if cfg.recompress:
        model_dir += f"-x{cfg.recompress}"
        return os.path.abspath(f"./ckpts/recompress/{model_dir}")
    return os.path.abspath(f"./ckpts/anchor/{model_dir}")


def _foreign(path: str) -> ValueError:
    return ValueError(
        f"{path} holds neither this port's {FILENAME} nor an orbax checkpoint of the JAX "
        f"package ({orbax.CHECKPOINT_METADATA}): train in another working directory or move it"
    )


class CheckpointManager:
    """Numbered step checkpoints plus a mirrored ``best_loss`` one.
    ``arch`` (the model family) maps an orbax step's flax parameters."""

    def __init__(self, directory: str, arch: str, max_to_keep: int = 3):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.arch = arch

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(os.path.join(self.directory, d)))

    def _write(self, path: str, payload: Dict[str, Any]) -> None:
        if os.path.isdir(path) and os.listdir(path) and not os.path.isfile(os.path.join(path, FILENAME)):
            if orbax.is_orbax_step(path):
                raise ValueError(f"{path} is an orbax checkpoint of the JAX package; this port "
                                 "does not write into one")
            raise _foreign(path)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, FILENAME + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, FILENAME))

    def save(self, step: int, state: TrainState, extra: Optional[Dict[str, Any]] = None,
             is_best: bool = False) -> None:
        payload = {"state": state.state_dict(), "extra": dict(extra or {})}
        self._write(os.path.join(self.directory, str(step)), payload)
        if is_best:
            best = os.path.join(self.directory, BEST)
            if os.path.isdir(best):
                shutil.rmtree(best)
            self._write(best, payload)
        for old in self._steps()[:-self.max_to_keep]:
            path = os.path.join(self.directory, str(old))
            if os.path.isfile(os.path.join(path, FILENAME)) or orbax.is_orbax_step(path):
                shutil.rmtree(path)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Load the latest (or given) step into ``state`` in place; returns
        its ``extra``, or None when there is no step to restore."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        if os.path.isfile(os.path.join(path, FILENAME)):
            payload = torch.load(os.path.join(path, FILENAME), map_location="cpu",
                                 weights_only=True)
            state.load_state_dict(payload["state"])
            return payload["extra"]
        if not orbax.is_orbax_step(path):
            raise _foreign(path)
        return orbax.restore(path, state, self.arch)
