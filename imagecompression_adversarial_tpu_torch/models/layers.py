"""Codec layers of the hyper codec (port of
``imagecompression_adversarial_tpu/models/layers.py``).

Activations are NCHW tensors; on the attack path they are kept in the
``channels_last`` memory format so that GDN's ``(rows, C)`` view needs no
copy.  ``Conv``/``Deconv`` are ``nn.Conv2d``/``nn.ConvTranspose2d`` with the
reference's padding, so their weights are in PyTorch's own layouts (OIHW,
and IOHW for the transposed conv) and CompressAI names load directly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.gdn import GDNFunction
from ..ops.bounds import lower_bound

# GDN reparametrization (CompressAI): parameters are stored as
# sqrt(value + pedestal) and bounded below before squaring
_REPARAM_OFFSET = 2 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_BOUND = (1e-6 + _PEDESTAL) ** 0.5  # beta >= 1e-6


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Conv(nn.Conv2d):
    """Strided conv with PyTorch-style symmetric padding k//2."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
        super().__init__(in_ch, out_ch, kernel_size, stride, kernel_size // 2)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init: kernel uniform(+-sqrt(3/fan_in)), bias
        uniform(+-1/sqrt(fan_in)), fan_in = k*k*in_ch."""
        k = self.kernel_size[0]
        fan_in = k * k * self.in_channels
        _uniform_(self.weight, math.sqrt(3.0 / fan_in), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)


class Deconv(nn.ConvTranspose2d):
    """``ConvTranspose2d(5, 2, padding=2, output_padding=1)``.

    ``forward(x, phase_output=True)`` gives its exact subpixel form without
    depth-to-space: ``(n, 4*out, h, w)`` with phase-major channels, whose
    ``depth_to_space`` is the plain output.
    """

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 5, 2, 2, output_padding=1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init: kernel fan_in k*k*in_ch, bias fan_in
        k*k*out_ch."""
        k = self.kernel_size[0]
        _uniform_(self.weight, math.sqrt(3.0 / (k * k * self.in_channels)), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(k * k * self.out_channels), generator)

    def forward(self, x: torch.Tensor, phase_output: bool = False) -> torch.Tensor:
        if not phase_output:
            return super().forward(x)
        return F.conv2d(x, self.phase_weight(), self.bias.repeat(4), padding=1)

    def phase_weight(self) -> torch.Tensor:
        """(4*out, in, 3, 3) weight of the subpixel conv.

        Output pixel o = 2i + k - 2 (tap k in 0..4), so the even phase takes
        taps {4, 2, 0} and the odd phase {-, 3, 1}; rows and columns factor.
        Output channel (2a + b) * out + f holds phase (a, b) of channel f.
        """
        w = self.weight  # (in, out, 5, 5)
        zero = torch.zeros_like(w[:, :, :1])
        rows = (w[:, :, [4, 2, 0]], torch.cat([zero, w[:, :, [3, 1]]], dim=2))
        phases = []
        for a in (0, 1):
            r = rows[a]
            zc = torch.zeros_like(r[..., :1])
            cols = (r[..., [4, 2, 0]], torch.cat([zc, r[..., [3, 1]]], dim=3))
            phases += [cols[0], cols[1]]
        return torch.cat(phases, dim=1).transpose(0, 1)  # (4*out, in, 3, 3)


def depth_to_space(y: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(n, block^2 * f, h, w) phase-major -> (n, f, block*h, block*w):
    ``out[:, f, 2m+a, 2n+b] = y[:, (2a+b)*f_total + f, m, n]``."""
    n, c, h, w = y.shape
    f = c // (block * block)
    y = y.reshape(n, block, block, f, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, f, block * h, block * w)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(n, f, H, W) -> (n, block^2 * f, H/block, W/block) phase-major."""
    n, f, hh, ww = x.shape
    h, w = hh // block, ww // block
    x = x.reshape(n, f, h, block, w, block).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, block * block * f, h, w)


class GDN(nn.Module):
    """Generalized divisive normalization ``x / sqrt(beta + gamma @ x^2)``;
    ``inverse=True`` gives IGDN (multiply by the sqrt).

    ``beta``/``gamma`` are stored in CompressAI's reparametrized space (sqrt
    with a pedestal).  The forward resolves them, then runs the fused kernel
    (``kernels/gdn.py``) on the channels_last ``(rows, C)`` view.
    ``use_kernel=False`` routes to the kernel's plain version on any device,
    for comparing the two on the card.
    """

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.use_kernel = True
        self.beta = nn.Parameter(torch.sqrt(torch.ones(channels) + _PEDESTAL))
        self.gamma = nn.Parameter(torch.sqrt(0.1 * torch.eye(channels) + _PEDESTAL))

    def resolved(self):
        """(gamma, beta) in the space the kernel takes."""
        beta = lower_bound(self.beta, _BETA_BOUND) ** 2 - _PEDESTAL
        gamma = lower_bound(self.gamma, _REPARAM_OFFSET) ** 2 - _PEDESTAL
        return gamma, beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        gamma, beta = self.resolved()
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        out = GDNFunction.apply(
            nhwc.reshape(-1, c), gamma.contiguous(), beta.contiguous(),
            self.inverse, self.use_kernel,
        )
        return out.view(n, h, w, c).permute(0, 3, 1, 2)
