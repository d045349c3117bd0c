"""Fully factorized entropy bottleneck (port of
``imagecompression_adversarial_tpu/entropy/factorized.py``).

Each channel owns a small monotone MLP in CDF-logit space::

    logits_{k+1} = softplus(H_k) @ logits_k + b_k
    logits_{k+1} += tanh(a_k) * tanh(logits_{k+1})      (all but the last)
    P(v) = sigmoid(logits(v + 1/2)) - sigmoid(logits(v - 1/2))

Parameters carry CompressAI's names (``_matrix0``, ``_bias0``, ``_factor0``,
``quantiles``), so the state_dict matches a CompressAI checkpoint.  The
evaluation layout is channel-major ``(C, 1, N)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bounds import lower_bound
from ..ops.quant import quantize

_LIKELIHOOD_BOUND = 1e-9
_FILTERS = (3, 3, 3, 3)  # hidden widths of the CDF-logit MLP
_INIT_SCALE = 10.0  # initial quantile spread
_TAIL_MASS = 1e-9  # probability mass the quantile range leaves outside


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        dims = (1,) + _FILTERS + (1,)
        self.n_layers = len(dims) - 1
        scale = _INIT_SCALE ** (1.0 / (len(_FILTERS) + 1))
        for k in range(self.n_layers):
            init = math.log(math.expm1(1.0 / scale / dims[k + 1]))
            self.register_parameter(
                f"_matrix{k}",
                nn.Parameter(torch.full((channels, dims[k + 1], dims[k]), init)),
            )
            self.register_parameter(
                f"_bias{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1))
            )
            if k < self.n_layers - 1:
                self.register_parameter(
                    f"_factor{k}", nn.Parameter(torch.zeros(channels, dims[k + 1], 1))
                )
        base = torch.tensor([-_INIT_SCALE, 0.0, _INIT_SCALE])
        self.quantiles = nn.Parameter(base.reshape(1, 1, 3).repeat(channels, 1, 1))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's random part: biases uniform(-0.5, 0.5)."""
        with torch.no_grad():
            for k in range(self.n_layers):
                getattr(self, f"_bias{k}").uniform_(-0.5, 0.5, generator=generator)

    def logits_cumulative(self, inputs: torch.Tensor, stop_gradient: bool = False) -> torch.Tensor:
        """CDF logits of ``inputs`` (C, 1, N); ``stop_gradient`` detaches the
        matrices, biases and factors, so that only ``inputs`` gets a
        gradient."""

        def param(name: str) -> torch.Tensor:
            p = getattr(self, name)
            return p.detach() if stop_gradient else p

        logits = inputs
        for k in range(self.n_layers):
            logits = torch.matmul(F.softplus(param(f"_matrix{k}")), logits) + param(f"_bias{k}")
            if k < self.n_layers - 1:
                logits = logits + torch.tanh(param(f"_factor{k}")) * torch.tanh(logits)
        return logits

    def likelihood(self, inputs: torch.Tensor) -> torch.Tensor:
        """Unit-bin likelihood of ``inputs`` (C, 1, N), sign trick for the
        tail."""
        lower = self.logits_cumulative(inputs - 0.5)
        upper = self.logits_cumulative(inputs + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def aux_loss(self) -> torch.Tensor:
        """Quantile-fitting loss, the aux optimizer's target: the CDF logits
        of ``quantiles`` against (-t, 0, t), t = log(2 / tail_mass - 1).
        Only ``quantiles`` gets a gradient."""
        logits = self.logits_cumulative(self.quantiles, stop_gradient=True)
        tail = math.log(2.0 / _TAIL_MASS - 1.0)
        target = torch.tensor([-tail, 0.0, tail], device=logits.device).reshape(1, 1, 3)
        return torch.sum(torch.abs(logits - target))

    @property
    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def forward(self, z: torch.Tensor, quant_mode: str = "noise",
                generator: Optional[torch.Generator] = None):
        """Quantize ``z`` (NCHW) and return ``(z_hat, likelihoods)``; the
        round-based modes are centred on the per-channel medians."""
        b, c, h, w = z.shape
        means = (
            self.medians.reshape(1, c, 1, 1) if quant_mode in ("dequantize", "ste") else None
        )
        z_hat = quantize(z, quant_mode, means=means, generator=generator)
        flat = z_hat.transpose(0, 1).reshape(c, 1, b * h * w)
        lik = lower_bound(self.likelihood(flat), _LIKELIHOOD_BOUND)
        return z_hat, lik.reshape(c, b, h, w).transpose(0, 1)
