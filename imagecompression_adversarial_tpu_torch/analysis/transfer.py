"""Adversarial-noise transferability (port of
``imagecompression_adversarial_tpu/analysis/transfer.py``):

* cross-image: attack each image, paste its noise onto every image of the
  corpus under the same model, and record the vi matrix;
* cross-model: attack under model i, evaluate the vi under model j.

The cross-model matrix keeps the JAX package's two host-staged phases: a
leg is a ready ``(fn, model)`` pair or a zero-argument thunk that returns
one.  With thunks only one model is alive at a time: (1) each source model
attacks every image, its noises go to host numpy, and the model is freed
(``gc.collect`` and ``torch.cuda.empty_cache``); (2) each target model
evaluates every staged (image, noise) pair.  On the card each leg's peak
device memory is printed beside the memory still allocated after it was
freed; the device's peak-memory statistic is reset after each leg.
"""

from __future__ import annotations

import gc
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..io.image import to_tensor
from ..utils.plotting import pyplot


def make_transfer_eval_fn(model) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(x, noise) -> vi`` of pasting a foreign noise onto the NCHW image
    ``x``: 10 log10 of the output MSE over the input MSE."""

    @torch.no_grad()
    def eval_fn(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        im_ = torch.clamp(x + noise, 0.0, 1.0)
        out_s = torch.clamp(model(x, quant_mode="dequantize")["x_hat"], 0.0, 1.0)
        out_adv = torch.clamp(model(im_, quant_mode="dequantize")["x_hat"], 0.0, 1.0)
        mse_in = torch.mean((im_ - x) ** 2)
        mse_out = torch.mean((out_adv - out_s) ** 2)
        return 10.0 * torch.log10(mse_out / mse_in)

    return eval_fn


def cross_image_matrix(attack_fn: Callable, eval_fn: Callable,
                       images: Sequence[torch.Tensor]) -> np.ndarray:
    """vi matrix[i, j]: the noise attacked on image i, pasted onto image j
    (NCHW images on the model's device; ``attack_fn(x)`` returns ``im_``)."""
    n = len(images)
    vis = np.zeros((n, n), np.float32)
    for i, src in enumerate(images):
        noise = attack_fn(src)["im_"] - src
        for j, dst in enumerate(images):
            vis[i, j] = float(eval_fn(dst, noise))
    return vis


def _materialize(entry):
    """A leg: a ready ``(fn, model)`` pair, or a thunk returning one."""
    return entry if isinstance(entry, tuple) else entry()


def _free_leg(lazy: bool) -> None:
    """Release a lazy leg's model and the memory cached for it."""
    if lazy:
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()


def _leg_memory(device: torch.device) -> Optional[str]:
    """The leg's peak device memory and what it left allocated, in GiB
    (the peak is reset for the next leg); None off the card."""
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    held = torch.cuda.memory_allocated(device) / 2**30
    torch.cuda.reset_peak_memory_stats(device)
    return f"peak {peak:.3f} GiB, {held:.3f} GiB allocated after it was freed"


def cross_model_matrix(attacks: List, evals: List, images: Sequence[np.ndarray],
                       log: Optional[Callable[[str], None]] = None) -> np.ndarray:
    """transfer_matrix[i, j]: the mean vi of the images attacked under model
    i, evaluated under model j.  ``images`` are (1, H, W, 3) numpy arrays;
    each leg runs them on its model's device."""
    n = len(attacks)
    lazy = any(not isinstance(e, tuple) for e in list(attacks) + list(evals))
    say = log if log is not None else (lambda s: print(s, flush=True))
    matrix = np.zeros((n, n), np.float32)

    # phase 1: attack under each source model, stage (image, noise) on the host
    staged = []
    for i, entry in enumerate(attacks):
        attack_fn, model = _materialize(entry)
        device = next(model.parameters()).device
        exs, x = [], None
        for k, im in enumerate(images):
            x = to_tensor(im, device)
            noise = (attack_fn(x)["im_"] - x).permute(0, 2, 3, 1).cpu().numpy()
            exs.append((np.asarray(im, np.float32), noise))
            say(f"[attack {i + 1}/{n}] image {k + 1}/{len(images)} done")
        staged.append(exs)
        del attack_fn, model, x
        _free_leg(lazy)
        mem = _leg_memory(device)
        if mem:
            say(f"[attack {i + 1}/{n}] memory: {mem}")

    # phase 2: evaluate every staged example under each target model
    for j, entry in enumerate(evals):
        eval_fn, model = _materialize(entry)
        device = next(model.parameters()).device
        for i in range(n):
            vals = [float(eval_fn(to_tensor(x, device), to_tensor(nz, device)))
                    for x, nz in staged[i]]
            matrix[i, j] = float(np.mean(vals))
            say(f"[eval col {j + 1}/{n}] row {i + 1}/{n}: {matrix[i, j]:.2f}")
        del eval_fn, model
        _free_leg(lazy)
        mem = _leg_memory(device)
        if mem:
            say(f"[eval {j + 1}/{n}] memory: {mem}")
    return matrix


def plot_matrix(matrix: np.ndarray, path: str, vmin=-4, vmax=25) -> None:
    """Annotated heatmap of a transfer matrix; needs matplotlib."""
    plt = pyplot()
    fig, ax = plt.subplots()
    ax.imshow(matrix, vmin=vmin, vmax=vmax)
    for i in range(matrix.shape[0]):
        for j in range(matrix.shape[1]):
            ax.text(j, i, int(matrix[i, j]), ha="center", va="center",
                    color="w", fontsize="xx-small")
    plt.tight_layout()
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)
