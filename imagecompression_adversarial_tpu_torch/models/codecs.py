"""Codec models (port of ``imagecompression_adversarial_tpu/models/codecs.py``;
this slice ports ``ScaleHyperprior`` only).

Module names follow CompressAI's ``nn.Sequential`` indices (``g_a.0``,
``h_s.4``, ``entropy_bottleneck._matrix0``), which are the torch names the
JAX converter (``io/convert.py``) maps from, so the state_dict is the
CompressAI one.  Quantization is an explicit ``quant_mode`` argument;
``'none'`` is the attack's quantization-free path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..entropy.factorized import EntropyBottleneck
from ..entropy.gaussian import gaussian_conditional
from .layers import GDN, Conv, Deconv

Result = Dict[str, Any]


class CodecModel(nn.Module):
    """Common interface: ``g_a`` / ``g_s`` / ``from_latent`` and the forward.

    ``supports_phase_synthesis`` is True iff ``g_s_phase`` computes exactly
    ``g_s`` up to the depth-to-space permutation; it gates the attack's
    phase-space loss (``attacks/rd.py``).
    """

    supports_phase_synthesis = False
    phase_reference_latent = "y_hat"

    def g_s_phase(self, y: torch.Tensor) -> torch.Tensor:
        """Synthesis ending in phase space: ``(n, 12, H/2, W/2)`` with the
        final deconv in its subpixel form and no depth-to-space, so
        ``depth_to_space(g_s_phase(y)) == g_s(y)``.  An MSE loss is
        invariant under that permutation and can use this tensor as is."""
        layers = list(self.g_s)
        for layer in layers[:-1]:
            y = layer(y)
        return layers[-1](y, phase_output=True)

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        raise NotImplementedError

    def forward(self, x, quant_mode: str = "noise",
                generator: Optional[torch.Generator] = None) -> Result:
        return self.from_latent(self.g_a(x), quant_mode, generator)


class ScaleHyperprior(CodecModel):
    """bmshj2018-hyperprior: 4x (conv5x5/2 + GDN) analysis, mirrored
    synthesis, and a scale-only hyper network: ``z = h_a(|y|)``,
    ``scales = h_s(z_hat)``."""

    supports_phase_synthesis = True

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = nn.Sequential(
            Conv(3, N), GDN(N), Conv(N, N), GDN(N), Conv(N, N), GDN(N), Conv(N, M)
        )
        self.g_s = nn.Sequential(
            Deconv(M, N), GDN(N, inverse=True), Deconv(N, N), GDN(N, inverse=True),
            Deconv(N, N), GDN(N, inverse=True), Deconv(N, 3),
        )
        self.h_a = nn.Sequential(
            Conv(M, N, 3, 1), nn.ReLU(), Conv(N, N), nn.ReLU(), Conv(N, N)
        )
        self.h_s = nn.Sequential(
            Deconv(N, N), nn.ReLU(), Deconv(N, N), nn.ReLU(), Conv(N, M, 3, 1), nn.ReLU()
        )
        self.entropy_bottleneck = EntropyBottleneck(N)

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        z = self.h_a(torch.abs(y))
        z_hat, z_lik = self.entropy_bottleneck(z, quant_mode, generator)
        scales = self.h_s(z_hat)
        y_hat, y_lik = gaussian_conditional(
            y, scales, quant_mode=quant_mode, generator=generator
        )
        return {
            "x_hat": self.g_s(y_hat),
            "y": y,
            "y_hat": y_hat,
            "z_hat": z_hat,
            "scales_hat": scales,
            "likelihoods": {"y": y_lik, "z": z_lik},
        }
