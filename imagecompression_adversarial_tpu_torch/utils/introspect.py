"""Per-layer introspection: activation capture and error propagation (port
of ``imagecompression_adversarial_tpu/utils/introspect.py``).

``layer_activations`` records every submodule's output with forward hooks,
where the JAX package uses flax's ``capture_intermediates``.  Activations
are keyed by the flax paths: a submodule's output is
``<flax module path>/__call__`` (``g_a.0`` -> ``g_a_0/__call__``, the
mapping of ``io/weights.py``), a tuple output gets ``[i]`` suffixes, and the
forward's result dict is flattened under ``__call__`` (``__call__/x_hat``,
``__call__/likelihoods/y``).  So the rows of ``layer_compare`` match the
JAX package's row by row; modules that flax has no counterpart for (the
``nn.ReLU`` layers of ``h_a``/``h_s``) add rows of their own, and
``nn.Sequential`` containers, which flax has not, add none.  Tensors are
NCHW.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..io.weights import flax_module_path
from .plotting import pyplot


def _flatten(out: Dict[str, Any], prefix: str, value: Any) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(out, f"{prefix}/{k}", v)
    elif isinstance(value, (tuple, list)):
        if len(value) == 1:
            _flatten(out, prefix, value[0])
        else:
            for i, v in enumerate(value):
                _flatten(out, f"{prefix}[{i}]", v)
    else:
        out[prefix] = value.detach() if isinstance(value, torch.Tensor) else value


@torch.no_grad()
def layer_activations(model: nn.Module, x: torch.Tensor,
                      method: Optional[Callable] = None) -> Dict[str, Any]:
    """Run ``method(x)`` (default: the ``dequantize`` forward, whose result
    is recorded too) and return every submodule's output, by path, sorted
    by path."""
    names = {m: name for name, m in model.named_modules()
             if name and not isinstance(m, nn.Sequential)}
    acts: Dict[str, Any] = {}

    def hook(module, inputs, output):
        _flatten(acts, "/".join(flax_module_path(names[module]) + ["__call__"]), output)

    handles = [m.register_forward_hook(hook) for m in names]
    try:
        if method is None:
            _flatten(acts, "__call__", model(x, quant_mode="dequantize"))
        else:
            method(x)
    finally:
        for h in handles:
            h.remove()
    return dict(sorted(acts.items()))


def layer_compare(model: nn.Module, x_a: torch.Tensor, x_b: torch.Tensor,
                  method: Optional[Callable] = None) -> List[Tuple[str, float, float]]:
    """Per-layer error propagation between two inputs:
    ``[(path, mean |a - b|, that over mean |a|)]`` in path order, for the
    floating-point activations of equal shapes."""
    acts_a = layer_activations(model, x_a, method)
    acts_b = layer_activations(model, x_b, method)
    rows = []
    for path, a in acts_a.items():
        b = acts_b.get(path)
        if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
            continue
        if a.shape != b.shape or not a.is_floating_point():
            continue
        err = float(torch.mean(torch.abs(a - b)))
        rows.append((path, err, err / (float(torch.mean(torch.abs(a))) + 1e-12)))
    return rows


def channel_maxima(y: torch.Tensor) -> np.ndarray:
    """Per-channel max |activation| of an NCHW latent."""
    return torch.amax(torch.abs(y), dim=(0, 2, 3)).cpu().numpy()


def show_max_bar(latents, labels, save_path: str, sort: bool = True) -> None:
    """Bar chart of the channel maxima of one or more latents (natural
    against adversarial), sorted by the first's; needs matplotlib."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 4))
    base = channel_maxima(latents[0])
    order = np.argsort(-base) if sort else np.arange(base.shape[0])
    width = 0.8 / len(latents)
    xs = np.arange(base.shape[0])
    for i, (y, label) in enumerate(zip(latents, labels)):
        ax.bar(xs + i * width, channel_maxima(y)[order], width=width, label=label)
    ax.set_xlabel("channel (sorted by natural max)" if sort else "channel")
    ax.set_ylabel("max |activation|")
    ax.legend()
    plt.tight_layout()
    plt.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
