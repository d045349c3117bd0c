"""HiFiC: the generative codec's encoder and generator over a mean-scale
hyperprior (port of ``imagecompression_adversarial_tpu/models/hific.py``).

* Encoder: conv7x7(60) + 4x strided conv3x3 (120/240/480/960), each with
  ChannelNorm and ReLU, then a conv3x3 to the 220-channel latent.
* Generator: ChannelNorm, conv3x3 to 960, ChannelNorm, 9 residual blocks
  with a long skip around them, 4x transposed conv3x3/2 with ChannelNorm
  and ReLU, conv7x7 to RGB.

The latent-conditioned patch discriminator (``HiFiCDiscriminator``)
belongs to GAN training (``train/gan.py``) and is a module of its own, out
of the codec's parameter tree.  Its convs are spectral-normalized as
``flax.linen.SpectralNorm`` does it (``SpectralNormConv``), not as
``torch.nn.utils.spectral_norm`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.factorized import EntropyBottleneck
from .codecs import MeanScaleHyperprior, _mean_scale_hyper
from .layers import Conv, Deconv, lecun_normal_


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


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SpectralNormConv(nn.Module):
    """``flax.linen.SpectralNorm(nn.Conv(out_ch, (k, k), strides=stride,
    padding="SAME"))`` with one power step.

    As flax does it, and unlike ``torch.nn.utils.spectral_norm``:
    * the OIHW weight is viewed as flax's HWIO kernel reshaped to
      ``(k * k * in_ch, out_ch)``, and ``u`` is ``(1, out_ch)``;
    * every call runs one power step from the stored ``u``, whatever
      ``update_stats`` is; ``u`` and ``v`` carry no gradient, ``sigma``
      does (through the weight);
    * ``update_stats=True`` stores the new ``u`` and ``sigma`` (buffers);
      ``False`` leaves them as they were.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 eps: float = 1e-12):
        super().__init__()
        self.stride, self.eps = stride, eps
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("u", torch.empty(1, out_ch))
        self.register_buffer("sigma", torch.ones(()))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init: a ``lecun_normal`` kernel, a zero bias, a standard
        normal ``u`` and ``sigma`` 1; the kernel is stored divided by the
        sigma of one power step from that ``u``, as flax's ``init`` stores
        the normalized kernel."""
        out_ch, in_ch, k, _ = self.weight.shape
        lecun_normal_(self.weight, k * k * in_ch, generator)
        with torch.no_grad():
            self.bias.zero_()
            self.u.copy_(torch.randn(self.u.shape, generator=generator))
            self.sigma.fill_(1.0)
            self.weight.copy_(self.normalized_weight(update_stats=False))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t(), self.eps)
            u = _l2_normalize(v @ w, self.eps)
        sigma = (v @ w @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        pads = []
        for n in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
            total = max((-(-n // s) - 1) * s + k - n, 0)  # flax "SAME"
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.normalized_weight(update_stats), self.bias, s)


class HiFiCDiscriminator(nn.Module):
    """The latent-conditioned patch discriminator (port of
    ``HiFiCDiscriminator`` in ``imagecompression_adversarial_tpu/models/hific.py``):
    the latent through a 3x3 ``Conv`` to 12 channels and a leaky ReLU
    (slope 0.2), resized to the image's size (nearest, as
    ``jax.image.resize`` picks: ``nearest-exact``) and concatenated after
    the image's channels; four spectral-normed 4x4 stride-2 convs (64, 128,
    256, 512; leaky ReLU 0.2) and a spectral-normed 1x1 conv to one logit a
    patch: ``(B, 1, H/16, W/16)``."""

    def __init__(self, latent_channels: int = 220, base: int = 64):
        super().__init__()
        self.latent_proj = Conv(latent_channels, 12, 3, 1)
        widths = [3 + 12, base, base * 2, base * 4, base * 8]
        for i in range(4):
            self.add_module(f"conv_{i}", SpectralNormConv(widths[i], widths[i + 1], 4, 2))
        self.logits = SpectralNormConv(widths[-1], 1, 1, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.latent_proj.reset_parameters(generator)
        for i in range(4):
            getattr(self, f"conv_{i}").reset_parameters(generator)
        self.logits.reset_parameters(generator)

    def forward(self, x: torch.Tensor, y_latent: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        lat = F.leaky_relu(self.latent_proj(y_latent), 0.2)
        lat = F.interpolate(lat, size=x.shape[2:], mode="nearest-exact")
        net = torch.cat([x, lat], dim=1)
        for i in range(4):
            net = F.leaky_relu(getattr(self, f"conv_{i}")(net, update_stats), 0.2)
        return self.logits(net, update_stats)


def init_discriminator(latent_channels: int = 220, seed: int = 1) -> HiFiCDiscriminator:
    """A discriminator with parameters drawn from a ``torch.Generator``
    seeded with ``seed`` (on the CPU; move it with ``.to``)."""
    disc = HiFiCDiscriminator(latent_channels)
    disc.reset_parameters(torch.Generator().manual_seed(seed))
    return disc
