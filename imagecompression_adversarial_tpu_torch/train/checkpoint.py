"""Checkpoints of the training state on ``torch.save`` (port of
``imagecompression_adversarial_tpu/train/checkpoint.py``, which uses orbax).

The directory scheme is the JAX package's:
``./ckpts/{anchor|adv|recompress}/{model}-{lambda}-{metric}[...]`` under
the working directory, one subdirectory a step (the newest ``max_to_keep``
kept) and a ``best_loss`` copy.  Each holds one ``checkpoint.pt``: params,
both optimizer states, the step and ``extra`` (epoch, eval loss, lr).

The port does not read orbax checkpoints.  A step directory without a
``checkpoint.pt`` (an orbax tree of the JAX package, such as the committed
``ckpts/adv/hyper-0.013-mse-0.0001-300/``) makes ``restore`` and ``save``
raise, naming the format; nothing in it is read, pruned or overwritten.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from ..io.weights import TRAIN_CHECKPOINT
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
    kind = ("an orbax checkpoint of the JAX package"
            if os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")) else "not this port's format")
    return ValueError(
        f"{path} holds no {FILENAME} ({kind}); this package reads and writes only its own "
        "torch.save checkpoints: train in another working directory or move that tree away"
    )


class CheckpointManager:
    """Numbered step checkpoints plus a mirrored ``best_loss`` one."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(os.path.join(self.directory, d)))

    def _write(self, path: str, payload: Dict[str, Any]) -> None:
        if os.path.isdir(path) and os.listdir(path) and not os.path.isfile(os.path.join(path, FILENAME)):
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
            self._write(os.path.join(self.directory, BEST), payload)
        for old in self._steps()[:-self.max_to_keep]:
            path = os.path.join(self.directory, str(old))
            if os.path.isfile(os.path.join(path, FILENAME)):
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
        if not os.path.isfile(os.path.join(path, FILENAME)):
            raise _foreign(path)
        payload = torch.load(os.path.join(path, FILENAME), map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return payload["extra"]
