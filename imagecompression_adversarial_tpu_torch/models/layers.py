"""Codec layers (port of ``imagecompression_adversarial_tpu/models/layers.py``).

Activations are NCHW tensors; on the attack path they are kept in the
``channels_last`` memory format so that GDN's ``(rows, C)`` view needs no
copy.  ``Conv``/``Deconv`` are ``nn.Conv2d``/``nn.ConvTranspose2d`` with the
reference's padding, so their weights are in PyTorch's own layouts (OIHW,
and IOHW for the transposed conv) and CompressAI names load directly.  The
cheng2020 blocks keep CompressAI's submodule names (``conv1``, ``gdn``,
``subpel_conv.0``, ...); their leaky ReLUs use slope 0.01, as flax's and
torch's defaults do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.gdn import GDNFunction
from ..ops import shard

# GDN reparametrization (CompressAI): parameters are stored as
# sqrt(value + pedestal) and bounded below before squaring
_REPARAM_OFFSET = 2 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2
_BETA_BOUND = (1e-6 + _PEDESTAL) ** 0.5  # beta >= 1e-6


def _uniform_(t: torch.Tensor, bound: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal`` (its ``nn.Conv`` and ``nn.Dense`` kernels): a
    normal truncated at two standard deviations, scaled so that its
    variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv(nn.Conv2d):
    """Strided conv with PyTorch-style symmetric padding k//2.  Under a row
    shard (``ops/shard.py``) it fetches its halo rows from the
    neighbouring shards."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
        super().__init__(in_ch, out_ch, kernel_size, stride, kernel_size // 2)

    def _conv_forward(self, x, weight, bias):
        rows = shard.row_axis()
        if rows is None:
            return super()._conv_forward(x, weight, bias)
        return shard.conv2d_rows(x, weight, bias, self.stride, self.padding, rows,
                                 type(self).__name__)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init: kernel uniform(+-sqrt(3/fan_in)), bias
        uniform(+-1/sqrt(fan_in)), fan_in = k*k*in_ch."""
        k = self.kernel_size[0]
        fan_in = k * k * self.in_channels
        _uniform_(self.weight, math.sqrt(3.0 / fan_in), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)


class Deconv(nn.ConvTranspose2d):
    """``ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)``, by
    default k=5, s=2.

    ``forward(x, phase_output=True)`` (k=5, s=2 only) gives its exact
    subpixel form without depth-to-space: ``(n, 4*out, h, w)`` with
    phase-major channels, whose ``depth_to_space`` is the plain output.
    Under a row shard it runs as that subpixel conv (with halo rows), then
    ``depth_to_space``, for k=5 and k=3 at stride 2; other kernels and
    strides raise there.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
        super().__init__(in_ch, out_ch, kernel_size, stride, kernel_size // 2,
                         output_padding=stride - 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference's init: kernel fan_in k*k*in_ch, bias fan_in
        k*k*out_ch."""
        k = self.kernel_size[0]
        _uniform_(self.weight, math.sqrt(3.0 / (k * k * self.in_channels)), generator)
        _uniform_(self.bias, 1.0 / math.sqrt(k * k * self.out_channels), generator)

    def forward(self, x: torch.Tensor, phase_output: bool = False) -> torch.Tensor:
        rows = shard.row_axis()
        if not phase_output and rows is None:
            return super().forward(x)
        k, s = self.kernel_size[0], self.stride[0]
        if s != 2 or k not in ((5,) if phase_output else (3, 5)):
            what = "phase_output requires kernel_size=5" if phase_output else \
                "a row shard requires kernel_size 3 or 5"
            raise ValueError(
                f"Deconv {what}/stride=2 (the subpel phase decomposition); got k={k}, s={s}"
            )
        if rows is None:
            return F.conv2d(x, self.phase_weight(), self.bias.repeat(4), padding=1)
        y = shard.conv2d_rows(x, self.phase_weight(), self.bias.repeat(4), (1, 1), (1, 1), rows,
                              "Deconv")
        return y if phase_output else depth_to_space(y)

    def phase_weight(self) -> torch.Tensor:
        """(4*out, in, 3, 3) weight of the subpixel conv, k = 5 or 3.

        Output pixel o = 2i - k//2 + t (tap t of k), so phase a of output
        row m = (o - a) / 2 reads input row m + d (d = -1, 0, +1 are the
        3x3 conv's offsets) through tap a + k//2 - 2d, where that lies in
        0..k-1, and through a zero elsewhere: for k=5 the even phase takes
        taps {4, 2, 0} and the odd phase {-, 3, 1}; for k=3 {-, 1, -} and
        {-, 2, 0}.  Rows and columns factor.  Output channel
        (2a + b) * out + f holds phase (a, b) of channel f.
        """
        w = self.weight  # (in, out, k, k)
        k = w.shape[2]
        taps = [[t if 0 <= t < k else k for t in (a + k // 2 - 2 * d for d in (-1, 0, 1))]
                for a in (0, 1)]
        idx = torch.tensor(taps, device=w.device)  # (phase, offset); k is a zero tap
        w = F.pad(w, (0, 1, 0, 1))[:, :, idx[:, None, :, None], idx[None, :, None, :]]
        # (in, out, a, b, 3, 3) -> (a, b, out, in, 3, 3)
        return w.permute(2, 3, 1, 0, 4, 5).reshape(-1, w.shape[0], 3, 3)


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


def _gdn_parameters(module: nn.Module, channels: int) -> None:
    """GDN's ``beta``/``gamma`` in CompressAI's reparametrized space."""
    module.beta = nn.Parameter(torch.sqrt(torch.ones(channels) + _PEDESTAL))
    module.gamma = nn.Parameter(torch.sqrt(0.1 * torch.eye(channels) + _PEDESTAL))


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
        _gdn_parameters(self, channels)

    def resolved(self):
        """(gamma, beta) in the space the kernel takes."""
        beta = shard.param_lower_bound(self.beta, _BETA_BOUND) ** 2 - _PEDESTAL
        gamma = shard.param_lower_bound(self.gamma, _REPARAM_OFFSET) ** 2 - _PEDESTAL
        return gamma, beta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        gamma, beta = self.resolved()
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        out = GDNFunction.apply(
            nhwc.reshape(n * h * w, c), gamma.contiguous(), beta.contiguous(),
            self.inverse, self.use_kernel,
        )
        return out.view(n, h, w, c).permute(0, 3, 1, 2)


class LinearGDN(nn.Module):
    """Divisive normalization by a linear pool of ``|x|``:
    ``x / (beta + gamma @ |x|)``, or ``x * (...)`` with ``inverse=True``.

    Same parameter space as ``GDN``, but the clamped reparametrized values
    are used as they are, without the square and the pedestal, as the
    reference does.  Plain PyTorch: no kernel of the reference computes it.
    """

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        _gdn_parameters(self, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = shard.param_lower_bound(self.beta, _BETA_BOUND)
        gamma = shard.param_lower_bound(self.gamma, _REPARAM_OFFSET)
        norm = torch.einsum("nihw,oi->nohw", torch.abs(x), gamma) + beta.reshape(1, -1, 1, 1)
        return x * norm if self.inverse else x / norm


class MaskedConv(Conv):
    """Type-A masked 5x5 stride-1 conv (the context model's
    ``context_prediction``): the centre tap and every tap after it in raster
    order are zeroed.  The mask multiplies the weight at use; it is a
    non-persistent buffer, so a CompressAI ``mask`` entry is not loaded."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 5, 1)
        mask = torch.ones(1, 1, 5, 5)
        mask[:, :, 2, 2:] = 0.0
        mask[:, :, 3:, :] = 0.0
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight * self.mask, self.bias)


class SubpelConv(nn.Sequential):
    """3x3 conv to ``4*C`` channels, then ``pixel_shuffle`` by 2
    (CompressAI's ``subpel_conv3x3``: the conv is ``.0``).

    ``forward(x, phase_output=True)`` returns the conv output as it is:
    ``(n, 4*C, h, w)`` in pixel_shuffle's channel order
    (``c*4 + i*2 + j``), whose ``pixel_shuffle`` is the plain output.
    """

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(Conv(in_ch, 4 * out_ch, 3, 1), nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor, phase_output: bool = False) -> torch.Tensor:
        y = self[0](x)
        return y if phase_output else self[1](y)


class ResidualBlock(nn.Module):
    """conv3x3 -> lrelu -> conv3x3 -> lrelu, plus the input (cheng2020 uses
    it at one width only, so it has no skip conv)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels, 3, 1)
        self.conv2 = Conv(channels, channels, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv1(x))
        return F.leaky_relu(self.conv2(y)) + x


class ResidualBlockWithStride(nn.Module):
    """conv3x3/2 -> lrelu -> conv3x3 -> GDN (the kernel), plus a 1x1/2
    skip conv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3, 2)
        self.conv2 = Conv(out_ch, out_ch, 3, 1)
        self.gdn = GDN(out_ch)
        self.skip = Conv(in_ch, out_ch, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gdn(self.conv2(F.leaky_relu(self.conv1(x)))) + self.skip(x)


class ResidualUnit(nn.Module):
    """Half-width bottleneck unit: 1x1 -> relu -> 3x3 -> relu -> 1x1,
    then relu of the sum with the input."""

    def __init__(self, channels: int):
        super().__init__()
        half = channels // 2
        self.conv1 = Conv(channels, half, 1, 1)
        self.conv2 = Conv(half, half, 3, 1)
        self.conv3 = Conv(half, channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(x + y)


class AttentionBlock(nn.Module):
    """cheng2020's attention block: a trunk of 3 residual units gated by
    the sigmoid of a mask branch (3 units and a 1x1 conv).  Submodules
    carry the reference's names (``trunk_0``, ``mask_2``, ``mask_conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        for i in range(3):
            self.add_module(f"trunk_{i}", ResidualUnit(channels))
        for i in range(3):
            self.add_module(f"mask_{i}", ResidualUnit(channels))
        self.mask_conv = Conv(channels, channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trunk, mask = x, x
        for i in range(3):
            trunk = getattr(self, f"trunk_{i}")(trunk)
            mask = getattr(self, f"mask_{i}")(mask)
        return x + trunk * torch.sigmoid(self.mask_conv(mask))


class ResidualBlockUpsample(nn.Module):
    """subpel conv -> lrelu -> conv3x3 -> IGDN (the kernel), subpel skip."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.subpel_conv = SubpelConv(in_ch, out_ch)
        self.conv = Conv(out_ch, out_ch, 3, 1)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = SubpelConv(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.igdn(self.conv(F.leaky_relu(self.subpel_conv(x))))
        return y + self.upsample(x)
