"""fic: the Weixin2021 CLIC "fast image compression" codec (port of
``imagecompression_adversarial_tpu/models/fic.py``).

conv/GDN analysis and synthesis (the GDN kernel), a mean-scale hyper
branch of N/3 channels, and ``Context4``, a checkerboard context model: the
latent splits into the 4 phases of a 2x2 cell, decoded in the order (0,0),
(1,1), (0,1), (1,0), and phase k is conditioned on the hyper features and
on the phases before it.  Estimation is 4 conv stacks in one pass; the real
coder (``entropy/codec.py``, ``context4``) encodes in one pass and decodes
in four.

The likelihood integrates the Gaussian over the bin of ``round(y)``
(``means_free_round``), the symbols the coder writes.  The synthesis
decodes the un-quantized latent ``y``, so the phase-space loss takes its
clean reference from ``y`` and a zero-initialized attack sits at an exact
critical point: attack fic with ``-random 2`` or more.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..entropy.factorized import EntropyBottleneck
from ..entropy.gaussian import gaussian_conditional
from ..ops import shard
from ..ops.quant import quantize
from .codecs import CodecModel, Result, _balle_analysis, _balle_synthesis, _mean_scale_hyper
from .layers import Conv

#: decode order of the 2x2-cell phases (row parity, column parity)
PHASE_ORDER = ((0, 0), (1, 1), (0, 1), (1, 0))


def phase_masks(h: int, w: int, device=None, row0: int = 0) -> torch.Tensor:
    """(4, 1, H, W) float masks of the phases, in decode order, for the
    rows ``row0`` to ``row0 + H`` of the latent (a row shard's block)."""
    ii = (torch.arange(h, device=device)[:, None] + row0) % 2
    jj = torch.arange(w, device=device)[None, :] % 2
    return torch.stack([((ii == a) & (jj == b)).float() for a, b in PHASE_ORDER])[:, None]


class Context4(nn.Module):
    """For each phase k: ``(scales_k, means_k) = ctx{k}([hyper_feats,
    y_hat * visible_k])``, a conv5x5 -> lrelu -> conv5x5 -> lrelu -> conv1x1
    stack, where ``visible_k`` masks in the phases before k; only phase k's
    positions of its output are kept.  Under a row shard the masks follow
    the block's global rows, and the 5x5 convs fetch the neighbours'
    ``y_hat * visible_k`` as their halo."""

    def __init__(self, M: int, hidden: int = 192):
        super().__init__()
        self.M = M
        for k in range(4):
            self.add_module(f"ctx{k}_0", Conv(3 * M, hidden, 5, 1))
            self.add_module(f"ctx{k}_2", Conv(hidden, hidden, 5, 1))
            self.add_module(f"ctx{k}_4", Conv(hidden, 2 * M, 1, 1))

    def forward(self, y_hat: torch.Tensor, hyper_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = y_hat.shape[2:]
        masks = phase_masks(h, w, y_hat.device, shard.row_offset(y_hat)).to(y_hat.dtype)
        scales = torch.zeros_like(y_hat)
        means = torch.zeros_like(y_hat)
        visible = torch.zeros_like(masks[0])
        for k in range(4):
            f = torch.cat([hyper_feats, y_hat * visible], dim=1)
            f = F.leaky_relu(getattr(self, f"ctx{k}_0")(f))
            f = F.leaky_relu(getattr(self, f"ctx{k}_2")(f))
            s_k, m_k = getattr(self, f"ctx{k}_4")(f).chunk(2, dim=1)
            scales = scales + s_k * masks[k]
            means = means + m_k * masks[k]
            visible = visible + masks[k]
        return scales, means


class FIC(CodecModel):
    """``model_clic.Image_coding(3, 32, 192, 42, 64)``'s shape: the hyper
    branch has max(N/3, 8) channels and Context4 N hidden channels."""

    entropy_structure = "context4"
    supports_phase_synthesis = True
    phase_reference_latent = "y"

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        hyper_ch = max(N // 3, 8)
        self.g_a = _balle_analysis(N, M)
        self.g_s = _balle_synthesis(N, M)
        self.h_a, self.h_s = _mean_scale_hyper(hyper_ch, M)
        self.entropy_bottleneck = EntropyBottleneck(hyper_ch)
        self.context = Context4(M, hidden=N)

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        z_hat, z_lik = self.entropy_bottleneck(self.h_a(y), quant_mode, generator)
        hyper_feats = self.h_s(z_hat)
        y_mode = "dequantize" if quant_mode in ("dequantize", "ste") else quant_mode
        y_hat = quantize(y, y_mode, means=None, generator=generator)
        scales, means = self.context(y_hat, hyper_feats)
        _, y_lik = gaussian_conditional(y, scales, means=means, quant_mode=quant_mode,
                                        generator=generator, means_free_round=True)
        return {
            "x_hat": self.g_s(y),
            "y": y,
            "y_hat": y_hat,
            "z_hat": z_hat,
            "scales_hat": scales,
            "means_hat": means,
            "likelihoods": {"y": y_lik, "z": z_lik},
        }
