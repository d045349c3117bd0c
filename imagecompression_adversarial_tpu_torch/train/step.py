"""Training state and step: main and aux optimizers (port of
``imagecompression_adversarial_tpu/train/step.py``).

* The main Adam runs over every parameter but the entropy bottleneck's
  ``quantiles``, after a global-norm clip of 1.0 of those gradients (the
  optax rule: scale by ``1 / norm`` when ``norm >= 1``, no epsilon, the
  norm over the main group only).
* The aux Adam (lr 1e-3) runs over exactly the ``quantiles``, on the aux
  loss of the parameters the main update has just written.
* ``ReduceLROnPlateau`` is the JAX package's host class (``metric <
  best``, patience 10, factor 0.5), not torch's, whose relative threshold
  gives another schedule.
* With a mesh (``parallel/mesh.py``) the step is one rank's part of a
  data-parallel step over ``dp`` (and, where the mesh has ``sp``, of a
  row-sharded one): the gradients are reduced before the clip, so the clip
  and both Adams see the global batch's, as optax does after XLA's psum.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..ops import shard
from .loss import rate_distortion_loss

#: The parameter name the aux optimizer owns.
AUX_NAME = "quantiles"
CLIP_NORM = 1.0
LR_AUX = 1e-3


def quantile_labels(model: torch.nn.Module) -> Dict[str, str]:
    """``'aux'`` for the parameters named ``quantiles``, ``'main'`` for the
    rest, by state-dict name."""
    return {name: "aux" if name.rsplit(".", 1)[-1] == AUX_NAME else "main"
            for name, _ in model.named_parameters()}


def parameter_groups(model: torch.nn.Module) -> Tuple[List[torch.nn.Parameter],
                                                      List[torch.nn.Parameter]]:
    """(main, aux) parameters: disjoint, and together every parameter."""
    labels = quantile_labels(model)
    params = dict(model.named_parameters())
    return ([p for n, p in params.items() if labels[n] == "main"],
            [p for n, p in params.items() if labels[n] == "aux"])


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float = CLIP_NORM) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global
    norm is at least ``max_norm`` (``optax.clip_by_global_norm``, on the
    device, no sync); returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """The codec being trained, its two optimizers and the step count."""

    model: torch.nn.Module
    opt: torch.optim.Adam
    aux_opt: torch.optim.Adam
    step: int = 0

    def state_dict(self) -> dict:
        """Params, both optimizer states and the step (references to the
        live tensors, as ``nn.Module.state_dict`` gives)."""
        return {
            "params": self.model.state_dict(),
            "opt_state": self.opt.state_dict(),
            "aux_opt_state": self.aux_opt.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, payload: dict) -> None:
        self.model.load_state_dict(payload["params"], strict=True)
        self.opt.load_state_dict(payload["opt_state"])
        self.aux_opt.load_state_dict(payload["aux_opt_state"])
        self.step = int(payload["step"])


def create_train_state(model: torch.nn.Module, lr: float = 1e-4) -> TrainState:
    """Both Adams (betas 0.9/0.999, eps 1e-8 outside the sqrt, as
    ``optax.scale_by_adam``) over the two groups of a trainable model."""
    main, aux = parameter_groups(model)
    return TrainState(model, torch.optim.Adam(main, lr=lr), torch.optim.Adam(aux, lr=LR_AUX))


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d params, zeros where a parameter does not reach the loss
    (so Adam's moments decay for it, as optax's do)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def mesh_shard(mesh, batch: torch.Tensor) -> shard.Shard:
    """The shard a mesh's rank holds of ``batch``: the batch split over
    ``dp``, and the rows over ``sp`` where the mesh has that axis (even
    where every rank's block of ``batch`` has one height: one gather of the
    heights a step, where each noise draw would gather them again)."""
    names = mesh.mesh_dim_names or ()
    rows = shard.mesh_axis(mesh, "sp") if "sp" in names else None
    even = rows is None or len(set(shard.block_heights(batch.shape[2], rows, batch))) == 1
    return shard.Shard(shard.mesh_axis(mesh, "dp"), rows, even)


def reduce_gradients_(grads: List[torch.Tensor], where: shard.Shard,
                      partial_rows: bool = True) -> None:
    """Make this rank's gradients the global batch's, in place: summed over
    the row shards (each holds its part of the loss's gradient; not where
    ``partial_rows`` is False, as for a loss of the parameters alone), then
    averaged over ``dp`` (each dp rank's loss is its block's mean)."""
    axes = ([where.rows] if partial_rows and where.rows is not None else []) + [where.batch]
    flat = torch.cat([g.reshape(-1) for g in grads])
    for axis in axes:
        shard.all_reduce_(flat, axis)
    flat /= where.batch.size
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def train_step(
    state: TrainState,
    batch: torch.Tensor,
    generator: torch.Generator,
    lr: float,
    lmbda: float,
    metric: str = "mse",
    recompress: bool = False,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """One RD step on ``batch`` (NCHW): the noise-quantized forward, the
    rate-distortion loss (plus ``0.01 * ||y - g_a(x_hat)||`` with
    ``recompress``), the clipped main Adam step at ``lr``, then the aux
    step.  Returns the logs as detached device tensors.

    With a ``mesh``, ``batch`` is this rank's block of the global batch
    (its rows too, where the mesh has ``sp``), ``generator`` is seeded
    alike on every rank (each draws the global batch's noise and keeps its
    block), and the logs are the global batch's on every rank.

    ``recompress``'s norm is the global batch's, as JAX's is however its
    batch is sharded: ``g_a(x_hat)`` runs under the shard (its convs fetch
    their halos), each rank sums its squares, and the sum over the rows and
    the batch (``shard.all_sum``, whose backward is the identity) goes
    under the ``sqrt``, so that each rank's gradient of the norm ``R`` is
    its part of ``dR``.  ``reduce_gradients_`` sums those parts over the
    rows and the dp ranks, then divides by ``dp``, as the RD loss (a mean
    of the dp blocks' means) needs; so each rank differentiates ``0.01 x
    dp x R``, and the step's gradient is that of JAX's ``loss + 0.01 x
    R``.  The logs keep ``0.01 x R``."""
    model = state.model
    main = state.opt.param_groups[0]["params"]
    aux = state.aux_opt.param_groups[0]["params"]
    where = mesh_shard(mesh, batch) if mesh is not None else None

    with shard.within(where) if where else contextlib.nullcontext():
        result = model(batch, quant_mode="noise", generator=generator)
        out = rate_distortion_loss(result, batch, lmbda, metric)
        objective = out["loss"]
        if recompress:
            f1 = model.g_a(result["x_hat"])
            squares = torch.sum((result["y"] - f1) ** 2)
            if where is not None:
                squares = shard.row_sum(shard.all_sum(squares, where.batch))
            out["recompress_loss"] = torch.sqrt(squares)
            out["loss"] = out["loss"] + 0.01 * out["recompress_loss"]
            scale = 1 if where is None else where.batch.size
            objective = objective + 0.01 * scale * out["recompress_loss"]
    grads = _grads(objective, main)
    if where is not None:
        reduce_gradients_(grads, where)
    clip_by_global_norm_(grads)
    for p, g in zip(main, grads):
        p.grad = g
    state.opt.param_groups[0]["lr"] = lr
    state.opt.step()

    aux_loss = model.aux_loss()
    aux_grads = _grads(aux_loss, aux)
    if where is not None:
        reduce_gradients_(aux_grads, where, partial_rows=False)
    for p, g in zip(aux, aux_grads):
        p.grad = g
    state.aux_opt.step()
    for p in main + aux:
        p.grad = None

    state.step += 1
    logs = {k: v.detach() for k, v in out.items()}
    logs["aux_loss"] = aux_loss.detach()
    if where is not None:
        # the row shards already hold the whole image's values
        keys = list(logs)
        flat = torch.stack([logs[k].reshape(()) for k in keys])
        shard.all_reduce_(flat, where.batch)
        logs = dict(zip(keys, (flat / where.batch.size).unbind()))
    return logs


class ReduceLROnPlateau:
    """Host-side plateau scheduler: factor 0.5, patience 10, min mode; an
    epoch is bad unless its metric is strictly below the best."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 10,
                 min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if self.best is None or metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
