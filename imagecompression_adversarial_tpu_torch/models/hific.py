"""HiFiC: the generative codec's encoder and generator over a mean-scale
hyperprior (port of ``imagecompression_adversarial_tpu/models/hific.py``).

* Encoder: conv7x7(60) + 4x strided conv3x3 (120/240/480/960), each with
  ChannelNorm and ReLU, then a conv3x3 to the 220-channel latent.
* Generator: ChannelNorm, conv3x3 to 960, ChannelNorm, 9 residual blocks
  with a long skip around them, 4x transposed conv3x3/2 with ChannelNorm
  and ReLU, conv7x7 to RGB.

The latent-conditioned patch discriminator belongs to GAN training and is
not part of the codec's parameter tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.factorized import EntropyBottleneck
from .codecs import MeanScaleHyperprior, _mean_scale_hyper
from .layers import Conv, Deconv


class ChannelNorm(nn.Module):
    """Normalize over the channels at each position (biased variance, eps
    1e-3), then the affine ``gamma``, ``beta``."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma.reshape(1, -1, 1, 1) + self.beta.reshape(1, -1, 1, 1)


class HiFiCResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, 1)
        self.norm1 = ChannelNorm(channels)
        self.conv2 = Conv(channels, channels, 3, 1)
        self.norm2 = ChannelNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        return x + self.norm2(self.conv2(y))


class HiFiCEncoder(nn.Module):
    def __init__(self, base: int = 60, bottleneck: int = 220, num_down: int = 4):
        super().__init__()
        self.num_down = num_down
        self.head = Conv(3, base, 7, 1)
        self.head_norm = ChannelNorm(base)
        for i in range(num_down):
            self.add_module(f"down_{i}", Conv(base * 2 ** i, base * 2 ** (i + 1), 3, 2))
            self.add_module(f"down_norm_{i}", ChannelNorm(base * 2 ** (i + 1)))
        self.tail = Conv(base * 2 ** num_down, bottleneck, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.head_norm(self.head(x)))
        for i in range(self.num_down):
            y = F.relu(getattr(self, f"down_norm_{i}")(getattr(self, f"down_{i}")(y)))
        return self.tail(y)


class HiFiCGenerator(nn.Module):
    def __init__(self, latent: int = 220, base: int = 60, num_up: int = 4,
                 num_residual_blocks: int = 9):
        super().__init__()
        self.num_up, self.num_residual_blocks = num_up, num_residual_blocks
        wide = base * 2 ** num_up
        self.head_norm0 = ChannelNorm(latent)
        self.head = Conv(latent, wide, 3, 1)
        self.head_norm1 = ChannelNorm(wide)
        for i in range(num_residual_blocks):
            self.add_module(f"block_{i}", HiFiCResidualBlock(wide))
        for scale in reversed(range(num_up)):
            self.add_module(f"up_{scale}", Deconv(base * 2 ** (scale + 1), base * 2 ** scale, 3, 2))
            self.add_module(f"up_norm_{scale}", ChannelNorm(base * 2 ** scale))
        self.tail = Conv(base, 3, 7, 1)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        h = self.head_norm1(self.head(self.head_norm0(y)))
        res = h
        for i in range(self.num_residual_blocks):
            res = getattr(self, f"block_{i}")(res)
        h = h + res  # the long skip
        for scale in reversed(range(self.num_up)):
            h = F.relu(getattr(self, f"up_norm_{scale}")(getattr(self, f"up_{scale}")(h)))
        return self.tail(h)


class HiFiC(MeanScaleHyperprior):
    """The generative codec with a mean-scale hyperprior (N = M = 220)."""

    def __init__(self, N: int = 220, M: int = 220):
        super().__init__()
        self.N, self.M = N, M
        self.encoder = HiFiCEncoder(bottleneck=M)
        self.generator = HiFiCGenerator(latent=M)
        self.h_a, self.h_s = _mean_scale_hyper(N, M)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def g_s(self, y: torch.Tensor) -> torch.Tensor:
        return self.generator(y)
