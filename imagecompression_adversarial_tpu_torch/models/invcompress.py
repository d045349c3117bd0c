"""InvCompress: an invertible analysis/synthesis pair (port of
``imagecompression_adversarial_tpu/models/invcompress.py``).

``g_a`` is four levels of [space-to-depth squeeze -> invertible 1x1 conv
-> 3 affine couplings] (kernel 5 on the first two levels, 3 on the last
two): 3 channels in, 768 at /16 out.  ``g_s`` runs the same network
backwards, so it shares every parameter with ``g_a``.  The latent is coded
by the joint autoregressive entropy structure at N_hyper = 768, whose
``h_a`` takes ``y`` (not ``|y|``) and whose ``h_s`` ends in subpel convs;
``entropy_parameters`` keeps the Sequential indices 0, 2 and 4 that the
context coder (``entropy/autoregressive.py::ARWeights``) reads.

NCHW layout: ``squeeze2`` orders the 4C output channels as (C, f1, f2),
the glow order of the reference's NHWC ``transpose(0, 1, 3, 5, 2, 4)``.

Under a row shard (``ops/shard.py``) the squeezes, the invertible 1x1
convs and the couplings' channel splits act on each block's own rows, and
the couplings' 5x5 and 3x3 convs fetch their halos: exact while every
block starts on an even row at each of the four levels (``squeeze2``
checks it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.factorized import EntropyBottleneck
from ..ops import shard
from .codecs import JointAutoregressive
from .layers import Conv, MaskedConv, SubpelConv

_SLOPE = 0.2  # the couplings' leaky ReLU


def squeeze2(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth by 2: channel ``c*4 + 2*f1 + f2`` holds pixel
    ``(2i + f1, 2j + f2)`` of channel c.  Under a row shard each block
    squeezes its own rows, which pairs the global rows right only when the
    block starts on an even row: its row count must be even."""
    n, c, h, w = x.shape
    if h % 2 and shard.row_axis() is not None:
        raise ValueError(f"squeeze2: a shard of {h} rows starts on an odd row at some rank; "
                         "the image height must divide by (shards x 64)")
    x = x.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * 4, h // 2, w // 2)


def unsqueeze2(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``squeeze2``."""
    n, c4, h, w = x.shape
    x = x.reshape(n, c4 // 4, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c4 // 4, h * 2, w * 2)


class ZeroConv(Conv):
    """A stride-1 conv initialized to zero, so a coupling starts as the
    identity (the reference's ``initialize_weights(conv3, 0)``)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.zero_()


class Bottleneck(nn.Module):
    """convK -> lrelu(0.2) -> conv1x1 -> lrelu(0.2) -> convK (zero init)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, kernel_size, 1)
        self.conv2 = Conv(out_ch, out_ch, 1, 1)
        self.conv3 = ZeroConv(out_ch, out_ch, kernel_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv1(x), _SLOPE)
        return self.conv3(F.leaky_relu(self.conv2(y), _SLOPE))


class CouplingLayer(nn.Module):
    """Affine coupling of the channel split (split1, split2):
    ``y1 = x1 * s(G2(x2)) + H2(x2)``, ``y2 = x2 * s(G1(y1)) + H1(y1)``, with
    ``s(v) = exp(clamp * (2 sigmoid(v) - 1))``; ``rev`` inverts it."""

    def __init__(self, split1: int, split2: int, kernel_size: int, clamp: float = 1.0):
        super().__init__()
        self.split1, self.clamp = split1, clamp
        self.G1 = Bottleneck(split1, split2, kernel_size)
        self.G2 = Bottleneck(split2, split1, kernel_size)
        self.H1 = Bottleneck(split1, split2, kernel_size)
        self.H2 = Bottleneck(split2, split1, kernel_size)

    def _s(self, v: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.clamp * (2.0 * torch.sigmoid(v) - 1.0))

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        x1, x2 = x[:, :self.split1], x[:, self.split1:]
        if not rev:
            y1 = x1 * self._s(self.G2(x2)) + self.H2(x2)
            y2 = x2 * self._s(self.G1(y1)) + self.H1(y1)
        else:
            y2 = (x2 - self.H1(x1)) / self._s(self.G1(x1))
            y1 = (x1 - self.H2(y2)) / self._s(self.G2(y2))
        return torch.cat([y1, y2], dim=1)


class InvertibleConv1x1(nn.Module):
    """Channel mixing by an invertible (in, out) matrix ``weight``, the
    reference's layout; ``rev`` applies its inverse."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """An orthogonal matrix: the Q of a normal draw, as the reference."""
        w = torch.randn(self.weight.shape, generator=generator)
        with torch.no_grad():
            self.weight.copy_(torch.linalg.qr(w)[0])

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        w = torch.linalg.inv(self.weight) if rev else self.weight
        return F.conv2d(x, w.t()[:, :, None, None])


class InvComp(nn.Module):
    """Four squeeze/mix/couple levels, ``mix_{l}`` and ``couple_{l}_{i}``."""

    KERNELS = (5, 5, 3, 3)

    def __init__(self):
        super().__init__()
        c = 3
        for lvl, k in enumerate(self.KERNELS):
            c *= 4
            self.add_module(f"mix_{lvl}", InvertibleConv1x1(c))
            for i in range(3):
                self.add_module(f"couple_{lvl}_{i}", CouplingLayer(c // 4, 3 * c // 4, k))

    def _level(self, lvl: int):
        return getattr(self, f"mix_{lvl}"), [getattr(self, f"couple_{lvl}_{i}") for i in range(3)]

    def forward(self, x: torch.Tensor, rev: bool = False) -> torch.Tensor:
        if not rev:
            for lvl in range(len(self.KERNELS)):
                mix, couples = self._level(lvl)
                x = mix(squeeze2(x))
                for cpl in couples:
                    x = cpl(x)
            return x
        for lvl in reversed(range(len(self.KERNELS))):
            mix, couples = self._level(lvl)
            for cpl in reversed(couples):
                x = cpl(x, rev=True)
            x = unsqueeze2(mix(x, rev=True))
        return x


class InvCompress(JointAutoregressive):
    """The invertible transforms over the joint autoregressive entropy
    structure at N_hyper = M = 768 (N is kept for the registry only)."""

    supports_phase_synthesis = False

    def __init__(self, N: int = 192, M: int = 768):
        nn.Module.__init__(self)
        self.N, self.M = N, M
        nh = M
        self.inv = InvComp()
        self.h_a = nn.Sequential(
            Conv(nh, nh, 3, 1), nn.LeakyReLU(), Conv(nh, nh, 3, 1), nn.LeakyReLU(),
            Conv(nh, nh, 3, 2), nn.LeakyReLU(), Conv(nh, nh, 3, 1), nn.LeakyReLU(),
            Conv(nh, nh, 3, 2),
        )
        self.h_s = nn.Sequential(
            Conv(nh, nh, 3, 1), nn.LeakyReLU(), SubpelConv(nh, nh), nn.LeakyReLU(),
            Conv(nh, nh * 3 // 2, 3, 1), nn.LeakyReLU(),
            SubpelConv(nh * 3 // 2, nh * 3 // 2), nn.LeakyReLU(),
            Conv(nh * 3 // 2, nh * 2, 3, 1),
        )
        self.context_prediction = MaskedConv(nh, 2 * nh)
        self.entropy_parameters = nn.Sequential(
            Conv(nh * 12 // 3, nh * 10 // 3, 1, 1), nn.LeakyReLU(),
            Conv(nh * 10 // 3, nh * 8 // 3, 1, 1), nn.LeakyReLU(),
            Conv(nh * 8 // 3, nh * 6 // 3, 1, 1),
        )
        self.entropy_bottleneck = EntropyBottleneck(nh)

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        return self.inv(x)

    def g_s(self, y: torch.Tensor) -> torch.Tensor:
        return self.inv(y, rev=True)
