"""The MLP image classifier that classifier-targeted attacks steer toward a
label (port of ``imagecompression_adversarial_tpu/models/classifier.py``):
3*28*28 -> 200 -> 100 -> 60 -> 30 -> 10 with ReLUs, and its trainer.

Inputs are NCHW images in [0, 1].  The JAX module flattens NHWC images, so
``forward`` permutes its input to NHWC before flattening: ``Dense_0``'s
rows keep flax's order, and a flax tree loads with each Dense kernel
transposed and nothing else moved.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import lecun_normal_

WIDTHS = (200, 100, 60, 30)


class MLPClassifier(nn.Module):
    """Dense layers ``Dense_0`` .. ``Dense_4`` (flax's names)."""

    def __init__(self, num_classes: int = 10, widths: Tuple[int, ...] = WIDTHS,
                 input_hw: int = 28):
        super().__init__()
        sizes = (3 * input_hw * input_hw,) + tuple(widths) + (num_classes,)
        for i in range(len(sizes) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(sizes[i], sizes[i + 1]))
        self.depth = len(sizes) - 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``Dense``'s init: ``lecun_normal`` kernels, zero biases."""
        for i in range(self.depth):
            dense = getattr(self, f"Dense_{i}")
            lecun_normal_(dense.weight, dense.in_features, generator)
            with torch.no_grad():
                dense.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC order
        for i in range(self.depth - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth - 1}")(x)


def init_classifier(seed: int = 0, input_hw: int = 28) -> MLPClassifier:
    """A classifier with parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` (on the CPU)."""
    module = MLPClassifier(input_hw=input_hw)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return module


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """``(n_out, n_in)`` float64 weights of torch's antialiased bilinear
    resize along one axis (``jax.image.resize(..., "bilinear")``, which
    antialiases when it shrinks), read off the resize of a basis."""
    basis = torch.eye(n_in, dtype=torch.float64).reshape(n_in, 1, 1, n_in)
    out = F.interpolate(basis, size=(1, n_out), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.reshape(n_in, n_out).t()


def make_logits_fn(module: MLPClassifier, hw: int = 28) -> Callable:
    """Classifier logits of codec-resolution NCHW reconstructions, resized
    to ``(hw, hw)`` bilinearly with antialiasing.  The resize runs as two
    products with ``resize_matrix`` weights (cached by input size): the
    same function as ``F.interpolate(..., antialias=True)``, whose CUDA
    backward adds with atomics, so an attack through it would not repeat
    itself on the card."""
    mats = {}

    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        key = (x.shape[2], x.shape[3], x.device, x.dtype)
        if key not in mats:
            mats[key] = (resize_matrix(x.shape[2], hw).to(x.device, x.dtype),
                         resize_matrix(x.shape[3], hw).to(x.device, x.dtype).t())
        a_h, a_wt = mats[key]
        return module(a_h @ x @ a_wt)

    return logits_fn


def train_classifier(
    batches: Iterator[Tuple[np.ndarray, np.ndarray]],
    steps: int = 1000,
    lr: float = 1e-3,
    seed: int = 0,
    input_hw: int = 28,
    device="cuda",
) -> Tuple[MLPClassifier, float]:
    """Adam on the softmax cross-entropy of ``(images NHWC, labels)``
    batches, ``steps`` steps: the first batch's step, then ``steps - 1``
    more, as the JAX trainer does.  Returns (module, final loss)."""
    module = init_classifier(seed, input_hw).to(device)
    opt = torch.optim.Adam(module.parameters(), lr=lr)

    def step(x, y) -> torch.Tensor:
        x = torch.from_numpy(np.asarray(x, np.float32)).to(device).permute(0, 3, 1, 2)
        y = torch.from_numpy(np.asarray(y, np.int64)).to(device)
        loss = F.cross_entropy(module(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    loss = step(*next(batches))
    for _, (x, y) in zip(range(steps - 1), batches):
        loss = step(x, y)
    return module, float(loss)
