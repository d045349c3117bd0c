"""NLAIC: non-local attention image compression (port of
``imagecompression_adversarial_tpu/models/nlaic.py``).

Convolutional transforms interleaved with Non-Local Attention Modules
(NLAM: a trunk of residual units gated by a mask branch headed by a global
self-attention), over the joint autoregressive entropy structure of
``JointAutoregressive``, so the context coder and the GDN kernel carry over.

The NLAMs sit inside the ``g_a``/``g_s`` Sequentials under the reference's
names (flax ``g_a_nlam_1`` is ``g_a.nlam_1``), after analysis stages 2
and 4 and before synthesis stages 1 and 3.  The inherited ``g_s_phase``
walks the Sequential, so it runs them too.

The non-local block attends over every latent position: at 768x512 the /4
block has 24,576 tokens, whose attention matrix would take 2.4 GB in
fp32.  ``F.scaled_dot_product_attention`` computes the same softmax
product without storing it (the memory-efficient backend on the card,
fp32); the JAX package writes it as two einsums.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import shard
from .codecs import JointAutoregressive, _balle_analysis, _balle_synthesis, _mean_scale_hyper
from .layers import Conv, ResidualUnit


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local attention, ``x + out(softmax(theta(x)
    phi(x)^T / sqrt(d)) g(x))`` over all H*W positions, d = C/2.  Under a
    row shard the queries are this rank's rows and the keys and values
    every rank's (``shard.shared_rows``, whose backward sums every rank's
    gradient of them)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 2, 1)
        self.theta = Conv(channels, inter, 1, 1)
        self.phi = Conv(channels, inter, 1, 1)
        self.g = Conv(channels, inter, 1, 1)
        self.out = Conv(inter, channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape

        def tokens(t):  # (n, 1, rows*W, d): one head
            return t.flatten(2).transpose(1, 2).unsqueeze(1)

        keys, values = self.phi(x), self.g(x)
        if shard.row_axis() is not None:  # every rank's rows, in one gather
            keys, values = shard.shared_rows(torch.cat([keys, values], dim=1)).chunk(2, dim=1)
        # the memory-efficient backend wants each token's channels contiguous
        att = F.scaled_dot_product_attention(tokens(self.theta(x)), tokens(keys).contiguous(),
                                             tokens(values).contiguous())
        att = att.squeeze(1).transpose(1, 2).reshape(n, -1, h, w)
        return x + self.out(att)


class NLAM(nn.Module):
    """Residual trunk gated by the sigmoid of a mask branch whose first
    stage is a non-local block (``nonlocal``, ``trunk_i``, ``mask_i``,
    ``mask_conv`` as in the reference)."""

    def __init__(self, channels: int):
        super().__init__()
        for i in range(3):
            self.add_module(f"trunk_{i}", ResidualUnit(channels))
        self.add_module("nonlocal", NonLocalBlock(channels))
        for i in range(3):
            self.add_module(f"mask_{i}", ResidualUnit(channels))
        self.mask_conv = Conv(channels, channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        trunk = x
        for i in range(3):
            trunk = getattr(self, f"trunk_{i}")(trunk)
        mask = getattr(self, "nonlocal")(x)
        for i in range(3):
            mask = getattr(self, f"mask_{i}")(mask)
        return x + trunk * torch.sigmoid(self.mask_conv(mask))


class NLAIC(JointAutoregressive):
    """mbt2018's transforms with NLAMs at the /4 and /16 scales."""

    @staticmethod
    def transforms(N: int, M: int):
        ga = list(_balle_analysis(N, M).named_children())
        gs = list(_balle_synthesis(N, M).named_children())
        g_a = nn.Sequential(OrderedDict(
            ga[:4] + [("nlam_1", NLAM(N))] + ga[4:] + [("nlam_2", NLAM(M))]
        ))
        g_s = nn.Sequential(OrderedDict(
            [("nlam_0", NLAM(M))] + gs[:4] + [("nlam_1", NLAM(N))] + gs[4:]
        ))
        return (g_a, g_s) + _mean_scale_hyper(N, M)
