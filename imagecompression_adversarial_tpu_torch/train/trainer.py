"""Training: RD training, adversarial finetuning (``--adv``) and
recompression-regularized training (``-re``); port of
``imagecompression_adversarial_tpu/train/trainer.py``.

* lambda from the quality table unless ``-lamb``; 200 epochs (100 with
  ``--adv``) unless ``-epochs``;
* ``--adv``: each batch is replaced by its adversarial example before the
  step (``attacks/rd.py::make_adv_example_fn``, the batch as one attack),
  with the input budget ramped over the first 100 steps; every 10 steps
  the eval attacks the held-out batch at budget 1e-4 and reports its vi;
  a hard stop at step 2000;
* otherwise the eval is the noise-quantized RD loss of the held-out batch,
  every 1000 steps with ``-re`` and 10000 without;
* ``ReduceLROnPlateau`` on the eval value, a checkpoint at each eval (and a
  ``best_loss`` copy), a final one, and resume from the latest step: the
  port's own, or an orbax step of the JAX trainer (``train/orbax.py``),
  whose ``extra.lr`` the scheduler takes up.

The noise of the quantization surrogate comes from a ``torch.Generator``
seeded with 42 at every start (resume included), as JAX seeds
``PRNGKey(42)``; the two streams differ, so parity tests inject the noise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from ..attacks.common import RDAttackConfig
from ..attacks.evaluate import evaluate
from ..attacks.rd import make_adv_example_fn
from ..config import Config
from ..io.image import to_tensor
from ..runtime import load_model
from .checkpoint import CheckpointManager, ckpt_dir_for
from .data import augment_dihedral, make_batches, prefetch
from .loss import lambda_for, rate_distortion_loss
from .step import ReduceLROnPlateau, create_train_state, train_step

#: The eval attack's input budget, whatever ``-noise`` says.
EVAL_NOISE_THRESHOLD = 1e-4
ADV_HARD_STOP = 2000
RAMP_STEPS = 100


def _append_curve(log_path: Optional[str], record: dict) -> None:
    """Append one JSONL training-curve record."""
    if not log_path:
        return
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    with open(log_path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _floats(logs: dict) -> dict:
    return {k: float(v) for k, v in logs.items()}


def train(cfg: Config, data_root: Optional[str] = None, max_steps: Optional[int] = None,
          crop: int = 256, augment: bool = False) -> dict:
    """Run training per ``cfg``; returns a summary: ``steps``, the last
    ``loss``, ``best_loss``, ``ckpt_dir``, the ``first`` and ``last`` step's
    logs, host ``timing`` (seconds; device work is synchronized at the
    window's ends), and the final ``state``."""
    model = load_model(cfg).requires_grad_(True)
    device = next(model.parameters()).device
    lamb = cfg.lamb if cfg.lamb is not None else lambda_for(cfg.metric, cfg.quality)
    print(f"Lambda: {lamb}")
    print(f"Learning rate (training): {cfg.lr_train}")

    state = create_train_state(model, cfg.lr_train)
    sched = ReduceLROnPlateau(cfg.lr_train)

    epochs_num = cfg.epochs or (100 if cfg.adv else 200)
    if cfg.debug:
        epochs_num = min(epochs_num, 2)
    ckpt_dir = ckpt_dir_for(cfg, lamb)
    print(f"Save ckpts to: {ckpt_dir}")
    ckpts = CheckpointManager(ckpt_dir, cfg.model)

    extra = ckpts.restore(state)
    start_epoch = 0
    if extra is not None:
        start_epoch = int(extra.get("epoch", 0)) + 1
        sched.lr = float(extra.get("lr", cfg.lr_train))
        print(f"resume training from epoch {start_epoch} (step {state.step})")

    adv_cfg = RDAttackConfig(steps=cfg.steps, lr=cfg.lr_attack, epsilon=cfg.epsilon,
                             clamp=cfg.clamp)
    adv_example = make_adv_example_fn(model, adv_cfg) if cfg.adv else None

    eval_batch = to_tensor(next(make_batches(data_root, cfg.batch_size, crop=crop, seed=999)),
                           device)

    def test_epoch() -> float:
        """The eval value: with ``--adv`` the vi of the held-out batch under
        a fresh attack at budget 1e-4, the whole batch as one image (its
        MSEs batch-wide, its bpp over one image's pixels); else the RD loss
        of the held-out batch."""
        if cfg.adv:
            im_adv = adv_example(eval_batch, EVAL_NOISE_THRESHOLD)
            with torch.no_grad():
                x_hat = model(eval_batch, quant_mode="dequantize")["x_hat"]
            output_s = x_hat.clamp(0.0, 1.0) if cfg.clamp else x_hat
            return float(evaluate(model, im_adv, eval_batch, output_s, clamp=cfg.clamp)["vi"])
        with torch.no_grad():
            result = model(eval_batch, quant_mode="noise",
                           generator=torch.Generator(device=device).manual_seed(0))
            return float(rate_distortion_loss(result, eval_batch, lamb, cfg.metric)["loss"])

    best_loss = float("inf")
    generator = torch.Generator(device=device).manual_seed(42)
    global_step = state.step
    first_step, trace_step = global_step + 1, global_step + 1  # trace the 2nd step
    logs, first = {}, None
    timing = {"first_step_s": 0.0, "steady_s": 0.0, "steady_steps": 0, "eval_s": 0.0,
              "attack_s": 0.0, "attack_steps": 0}
    stop = False
    epoch = start_epoch

    def checkpoint(loss: float, epoch_done: int) -> None:
        nonlocal best_loss
        is_best = loss < best_loss
        best_loss = min(loss, best_loss)
        ckpts.save(global_step, state, extra={"epoch": epoch_done, "loss": loss, "lr": sched.lr},
                   is_best=is_best)

    train_stream = make_batches(data_root, cfg.batch_size, crop=crop)
    if augment:
        train_stream = augment_dihedral(train_stream)
    batches = prefetch(train_stream)
    t0 = time.time()
    t_steady = None
    try:
        for epoch in range(start_epoch, epochs_num):
            for batch_np in batches:
                batch = to_tensor(batch_np, device)
                if cfg.adv:
                    thresh = cfg.noise * min(global_step, RAMP_STEPS) / RAMP_STEPS
                    t = time.time()
                    batch = adv_example(batch, thresh)
                    _sync(device)
                    timing["attack_s"] += time.time() - t
                    timing["attack_steps"] += cfg.steps

                step_args = (state, batch, generator, sched.lr, lamb, cfg.metric,
                             bool(cfg.recompress))
                if cfg.trace and global_step == trace_step:
                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    with torch.profiler.profile(activities=acts) as prof:
                        logs = train_step(*step_args)
                        _sync(device)
                    os.makedirs(cfg.trace, exist_ok=True)
                    path = os.path.join(cfg.trace, f"train_step_{global_step + 1}.json")
                    prof.export_chrome_trace(path)
                    print(f"[trace] torch.profiler trace written to {path}")
                else:
                    logs = train_step(*step_args)
                global_step += 1
                if global_step == first_step:
                    first = _floats(logs)
                    timing["first_step_s"] = time.time() - t0
                    print(f"step: {global_step} (first) loss: {first['loss']:.4f} "
                          f"t: {timing['first_step_s']:.1f}s", flush=True)
                    t_steady = time.time()

                if global_step % 200 == 0:
                    print(f"step: {global_step} loss: {float(logs['loss']):.4f} "
                          f"t: {time.time() - t0:.1f}s", flush=True)

                eval_every = 10 if cfg.adv else (1000 if cfg.recompress else 10000)
                if global_step % eval_every == 0:
                    t = time.time()
                    loss = test_epoch()
                    lr = sched.step(loss)
                    print(
                        f"step: {global_step} loss: {float(logs['loss']):.4f} "
                        f"distortion: {float(logs['distortion']):.6f} "
                        f"rate: {float(logs['bpp_loss']):.4f} lr: {lr:g} "
                        f"eval: {loss:.4f} t: {time.time() - t0:.1f}s"
                    )
                    _append_curve(cfg.log, {
                        "step": global_step, "loss": float(logs["loss"]),
                        "distortion": float(logs["distortion"]),
                        "bpp": float(logs["bpp_loss"]), "lr": lr,
                        "eval_loss": loss, "t": round(time.time() - t0, 2),
                    })
                    checkpoint(loss, epoch)
                    timing["eval_s"] += time.time() - t

                if cfg.adv and global_step >= ADV_HARD_STOP:
                    stop = True
                if max_steps is not None and global_step >= max_steps:
                    stop = True
                if stop:
                    break
            if stop:
                break
            if not cfg.adv:
                t = time.time()
                loss = test_epoch()
                sched.step(loss)
                checkpoint(loss, epoch)
                timing["eval_s"] += time.time() - t
    finally:
        batches.close()
    _sync(device)
    if t_steady is not None:
        timing["steady_s"] = time.time() - t_steady - timing["eval_s"]
        timing["steady_steps"] = global_step - first_step

    # the final checkpoint; a mid-epoch stop records epoch - 1, so that a
    # resume re-enters the same epoch
    if global_step > 0 and ckpts.latest_step() != global_step:
        t = time.time()
        checkpoint(test_epoch(), (epoch - 1) if stop else epoch)
        timing["eval_s"] += time.time() - t

    return {
        "steps": global_step,
        "loss": float(logs["loss"]) if logs else None,
        "best_loss": best_loss,
        "ckpt_dir": ckpt_dir,
        "first": first,
        "last": _floats(logs) if logs else None,
        "timing": timing,
        "state": state,
    }
