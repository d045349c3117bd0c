"""Attack plumbing: config, LR schedule, Adam on the noise tensor, noise
init, the forward-only phase loop (port of
``imagecompression_adversarial_tpu/attacks/common.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RDAttackConfig:
    """Knobs of the canonical RD distortion attack.

    ``defend_in_loop`` (``'ensemble'``, ``'bitdepth'``, ``'resize'`` or
    ``'clip'``) makes the attack adaptive: the output loss goes through
    that defense; ``ensemble_impl`` says how the in-loop self-ensemble runs
    its 8 variants.  ``debug_model`` (the reference's debug fixture) draws
    the initial noise from uniform(+-sqrt(noise_threshold)) and leaves the
    input unclipped.  ``phase_space_loss=None`` (auto) turns the
    phase-space loss on for the plain L2 attack on a codec with an exact
    phase synthesis.  ``two_phase_impl='cond'`` decides the phase with a
    host ``if`` (one device sync a step); ``'select'`` always runs the
    output phase and blends with ``torch.where`` (no sync).

    ``split_eval`` runs the large-image attack (``attacks/rd.py``): the
    phase-space loss's autograd graph checkpointed by stage; it needs the
    phase-space loss and takes one image at a time.  ``remat`` is accepted
    and ignored: the single-program attack keeps every activation (at
    768x512 they fit on an 80 GB card, and a recompute would slow it),
    and the split attack always recomputes.
    """

    steps: int = 1001
    lr: float = 0.01
    noise_threshold: float = 1e-4  # L2 input budget (`-noise`)
    epsilon: float = 16.0  # L-inf budget in /255 units (`-e`)
    att_metric: str = "L2"  # 'L2' | 'ms-ssim'
    clamp: bool = True
    random_restarts: int = 1
    lr_milgamma: float = 0.33
    debug_model: bool = False
    defend_in_loop: Optional[str] = None  # None|'ensemble'|'bitdepth'|'resize'|'clip'
    ensemble_impl: str = "scan"  # 'scan' (one checkpointed variant at a time) | 'batch'
    pad: Optional[int] = None
    padding_mode: str = "reflect"
    remat: bool = True
    phase_space_loss: Optional[bool] = None
    split_eval: bool = False
    two_phase_impl: str = "cond"


def multistep_lr_schedule(
    steps: int, base_lr: float, gamma: float = 0.33, n_decays: int = 3
) -> np.ndarray:
    """Per-iteration LR of torch MultiStepLR([1, 2, 3], gamma) stepped at
    every ``i % (steps // 3) == 0`` (the decay applies from the next
    iteration; at most 3 decays)."""
    d = max(steps // 3, 1)
    lrs = np.empty(steps, np.float64)
    factor = 1.0
    epoch = 0
    for i in range(steps):
        lrs[i] = base_lr * factor
        if i % d == 0:
            epoch += 1
            if epoch <= n_decays:
                factor *= gamma
    return lrs.astype(np.float32)


class AdamOnNoise:
    """Bias-corrected Adam with eps outside the sqrt (``optax.scale_by_adam``
    with ``eps_root=0``, torch's Adam), updating the noise tensor in place."""

    def __init__(self, noise: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = torch.zeros_like(noise)
        self.nu = torch.zeros_like(noise)
        self.count = 0

    @torch.no_grad()
    def step(self, noise: torch.Tensor, grad: torch.Tensor, lr: float) -> None:
        self.count += 1
        self.mu.mul_(self.b1).add_(grad, alpha=1.0 - self.b1)
        self.nu.mul_(self.b2).addcmul_(grad, grad, value=1.0 - self.b2)
        mu_hat = self.mu / (1.0 - self.b1 ** self.count)
        nu_hat = self.nu / (1.0 - self.b2 ** self.count)
        noise.sub_(lr * mu_hat / (torch.sqrt(nu_hat) + self.eps))


def init_noise(
    shape: Tuple[int, ...],
    cfg: RDAttackConfig,
    generator: Optional[torch.Generator],
    device: torch.device,
) -> torch.Tensor:
    """Zeros normally; from ``generator``, uniform(-1e-2, 1e-2) for random
    restarts and uniform(+-sqrt(noise_threshold)) for the debug fixture."""
    if cfg.debug_model:
        bound = float(np.sqrt(cfg.noise_threshold))
    elif cfg.random_restarts > 1:
        bound = 1e-2
    else:
        return torch.zeros(shape, device=device)
    if generator is None:
        raise ValueError("random noise init needs a torch.Generator")
    u = torch.rand(shape, generator=generator, device=device)
    return (2.0 * u - 1.0) * bound


def make_phase_fwd_scan(model, steps: int):
    """Forward-only loop of the RD attack's in-loop computation: ``g_a``
    then the phase-space synthesis, no hyper path, no likelihoods.  A full
    forward and backward step can never beat its rate.  The steps are
    chained through the image-shaped noise (updated from the output's
    mean), as JAX's scan is, so no step can be skipped or hoisted; the
    loop holds no host sync.  It runs where the model's parameters are,
    under ``torch.no_grad()``; the function returns the final noise."""

    def scan(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            n = torch.zeros_like(x)
            for _ in range(steps):
                out = model.g_s_phase(model.g_a(x + n))
                n = n + 1e-6 * out.mean()
        return n

    return scan
