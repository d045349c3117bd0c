"""TIC: a Swin-style transformer codec (port of
``imagecompression_adversarial_tpu/models/tic.py``).

``g_a`` is 4 stages of [conv3x3/2 patch embedding, a window-attention
block, a shifted one]; ``g_s`` mirrors it with transposed convs
(``Deconv(k=3, s=2)``, which has no phase form, so the attack's loss stays
at full resolution).  A mean-scale hyperprior
(``codecs.MeanScaleHyperprior``) codes the latent.

The blocks work in NHWC, as the reference: ``nn.Linear`` layers hold the
flax ``Dense`` kernels transposed, the layer norms keep flax's eps 1e-6,
and the MLP's GELU is flax's tanh approximation.  The attention of a 4x4
window is 16 tokens, so it is written out as matmuls.

Under a row shard (``ops/shard.py``) each block's rows hold whole windows
(its row count divides by 4 at every stage), the shifted block's roll of
the rows wraps across the ranks (``shard.roll_rows``), and the layer
norms, Dense layers and MLP act on each token alone.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.factorized import EntropyBottleneck
from ..ops import shard
from .codecs import MeanScaleHyperprior, _mean_scale_hyper
from .layers import Conv, Deconv

_LN_EPS = 1e-6  # flax nn.LayerNorm


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C)."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_merge(x: torch.Tensor, w: int, b: int, h: int, ww: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    c = x.shape[-1]
    x = x.reshape(b, h // w, ww // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, c)


class Dense(nn.Linear):
    """``nn.Linear`` with a seeded init: kernel uniform(+-sqrt(3/fan_in)),
    the variance of flax's lecun_normal, and a zero bias as flax's."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = math.sqrt(3.0 / self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()


class WindowAttention(nn.Module):
    """Multi-head self-attention within each window, plus a learned
    relative position bias ``rel_bias`` (heads, 2w-1, 2w-1)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.dim, self.num_heads, self.window = dim, num_heads, window
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros(num_heads, 2 * window - 1, 2 * window - 1))
        idx = torch.arange(window)
        dy = idx[:, None] - idx[None, :] + window - 1
        self.register_buffer("dy", dy, persistent=False)

    def bias(self) -> torch.Tensor:
        """(heads, T, T): token (i, j) to (i', j') gets rel[h, dy(i,i'), dy(j,j')]."""
        dy = self.dy
        t = self.window * self.window
        return self.rel_bias[:, dy[:, None, :, None], dy[None, :, None, :]].reshape(
            self.num_heads, t, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (nW, T, C)
        nw, t, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(nw, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (nW, heads, T, hd)
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + self.bias(), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(nw, t, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    """LN -> (shifted) window attention -> residual, LN -> MLP -> residual,
    on NHWC tensors."""

    def __init__(self, dim: int, num_heads: int, window: int = 4, shift: bool = False,
                 mlp_ratio: float = 2.0):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.mlp1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        win = self.window
        if h % win and shard.row_axis() is not None:
            raise ValueError(f"SwinBlock: a shard of {h} rows does not divide into {win}-row "
                             "windows; the image height must divide by (shards x 64)")
        # jnp.roll by -win // 2, which is -2 for win 4, and back by win // 2;
        # the rows (dim 1) roll across the row shards, with wrap-around
        back, fwd = -win // 2, win // 2
        y = self.norm1(x)
        if self.shift:
            y = torch.roll(shard.roll_rows(y, back, dim=1), back, dims=2)
        y = window_merge(self.attn(window_partition(y, win)), win, b, h, w)
        if self.shift:
            y = torch.roll(shard.roll_rows(y, fwd, dim=1), fwd, dims=2)
        x = x + y
        z = self.mlp2(F.gelu(self.mlp1(self.norm2(x)), approximate="tanh"))
        return x + z


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class TIC(MeanScaleHyperprior):
    """4 conv-downsample stages with paired (plain, shifted) window
    attention blocks, a mirrored synthesis and a mean-scale hyperprior.
    Modules carry the reference's names (``embed_i``, ``enc_i_j``,
    ``dec_i_j``, ``unembed_i``)."""

    window = 4
    heads: Tuple[int, ...] = (4, 8, 8, 8)

    def __init__(self, N: int = 128, M: int = 192):
        super().__init__()
        self.N, self.M = N, M
        dims = (N, N, N, M)
        for i, d in enumerate(dims):
            self.add_module(f"embed_{i}", Conv(3 if i == 0 else dims[i - 1], d, 3, 2))
            for j in range(2):
                self.add_module(f"enc_{i}_{j}", SwinBlock(d, self.heads[i], self.window, j == 1))
        rdims = (N, N, N, 3)
        for i in range(4):
            d = dims[3 - i]
            for j in range(2):
                self.add_module(f"dec_{i}_{j}",
                                SwinBlock(d, self.heads[3 - i], self.window, j == 1))
            self.add_module(f"unembed_{i}", Deconv(d, rdims[i], 3, 2))
        self.h_a, self.h_s = _mean_scale_hyper(N, M)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def g_a(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = _nhwc(getattr(self, f"embed_{i}")(x))
            x = getattr(self, f"enc_{i}_1")(getattr(self, f"enc_{i}_0")(x))
            x = _nchw(x)
        return x

    def g_s(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            y = getattr(self, f"dec_{i}_1")(getattr(self, f"dec_{i}_0")(_nhwc(y)))
            y = getattr(self, f"unembed_{i}")(_nchw(y))
        return y
