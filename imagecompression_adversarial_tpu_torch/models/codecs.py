"""Codec models (port of ``imagecompression_adversarial_tpu/models/codecs.py``):
``FactorizedPrior``, ``ScaleHyperprior``, ``JointAutoregressive`` (mbt2018,
"context"), the cheng2020 family (anchor, attention, attention + GMM), the
reference's one-layer ``DebugCodec`` and ``MeanScaleHyperprior``, the base
of the adapter families tic and hific (``models/tic.py``, ``hific.py``).

Module names follow CompressAI's ``nn.Sequential`` indices (``g_a.0``,
``h_s.2.0``, ``entropy_parameters.4``, ``entropy_bottleneck._matrix0``),
which are the torch names the JAX converter (``io/convert.py``) maps from,
so the state_dict is the CompressAI one.  The attention blocks, which that
converter does not know, sit inside ``g_a``/``g_s`` under the reference's
names (``g_a.attn_1`` for flax ``g_a_attn_1``).  Quantization is an
explicit ``quant_mode`` argument; ``'none'`` is the attack's
quantization-free path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..entropy.factorized import EntropyBottleneck
from ..entropy.gaussian import gaussian_conditional, gaussian_mixture_conditional
from ..ops.quant import quantize
from .layers import (
    GDN,
    AttentionBlock,
    Conv,
    Deconv,
    MaskedConv,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv,
)

Result = Dict[str, Any]


def _balle_analysis(n: int, m: int) -> nn.Sequential:
    """4x (conv5x5/2), GDN between: factorized, hyper and context."""
    return nn.Sequential(
        Conv(3, n), GDN(n), Conv(n, n), GDN(n), Conv(n, n), GDN(n), Conv(n, m)
    )


def _balle_synthesis(n: int, m: int) -> nn.Sequential:
    """4x (deconv5x5/2), IGDN between; the last one ends in 3 channels."""
    return nn.Sequential(
        Deconv(m, n), GDN(n, inverse=True), Deconv(n, n), GDN(n, inverse=True),
        Deconv(n, n), GDN(n, inverse=True), Deconv(n, 3),
    )


def _mean_scale_hyper(n: int, m: int) -> Tuple[nn.Sequential, nn.Sequential]:
    """(h_a, h_s) of mbt2018 and of the debug codec: h_s emits 2M channels
    (scales and means)."""
    h_a = nn.Sequential(
        Conv(m, n, 3, 1), nn.LeakyReLU(), Conv(n, n), nn.LeakyReLU(), Conv(n, n)
    )
    h_s = nn.Sequential(
        Deconv(n, m), nn.LeakyReLU(), Deconv(m, m * 3 // 2), nn.LeakyReLU(),
        Conv(m * 3 // 2, m * 2, 3, 1),
    )
    return h_a, h_s


class CodecModel(nn.Module):
    """Common interface: ``g_a`` / ``g_s`` / ``from_latent`` and the forward.

    ``supports_phase_synthesis`` is True iff ``g_s_phase`` computes exactly
    ``g_s`` up to a fixed permutation of the last layer's output; it gates
    the attack's phase-space loss (``attacks/rd.py``).

    ``entropy_structure`` tells the real coder (``entropy/codec.py``) how
    the symbols are conditioned: ``'factorized'``, ``'scale_hyper'``,
    ``'mean_scale'``, ``'context'``, ``'context_gmm'``, ``'context4'`` or
    ``'none'`` (no real coder).  ``phase_reference_latent`` names the
    result entry that ``g_s`` decodes (fic decodes ``'y'``).
    """

    entropy_structure = "none"
    supports_phase_synthesis = False
    phase_reference_latent = "y_hat"

    def g_s_phase(self, y: torch.Tensor) -> torch.Tensor:
        """Synthesis ending in phase space: ``(n, 12, H/2, W/2)``, the last
        layer's output before its upsampling permutation.  For a final
        ``Deconv`` that is its subpixel form, with ``depth_to_space`` as the
        permutation; for a final ``SubpelConv`` (cheng2020) its conv, with
        ``pixel_shuffle``.  An MSE loss is invariant under either and can
        use this tensor as is."""
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

    def aux_loss(self) -> torch.Tensor:
        """The entropy bottleneck's quantile-fitting loss (every family
        here has one)."""
        return self.entropy_bottleneck.aux_loss()


class FactorizedPrior(CodecModel):
    """bmshj2018-factorized: the hyper codec's transforms with a fully
    factorized entropy model on y."""

    entropy_structure = "factorized"
    supports_phase_synthesis = True

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = _balle_analysis(N, M)
        self.g_s = _balle_synthesis(N, M)
        self.entropy_bottleneck = EntropyBottleneck(M)

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        y_hat, y_lik = self.entropy_bottleneck(y, quant_mode, generator)
        return {"x_hat": self.g_s(y_hat), "y": y, "y_hat": y_hat, "likelihoods": {"y": y_lik}}


class ScaleHyperprior(CodecModel):
    """bmshj2018-hyperprior: 4x (conv5x5/2 + GDN) analysis, mirrored
    synthesis, and a scale-only hyper network: ``z = h_a(|y|)``,
    ``scales = h_s(z_hat)``."""

    entropy_structure = "scale_hyper"
    supports_phase_synthesis = True

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = _balle_analysis(N, M)
        self.g_s = _balle_synthesis(N, M)
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


class MeanScaleHyperprior(CodecModel):
    """The mean-scale hyperprior of tic and hific (subclasses build
    ``g_a``/``g_s``, ``h_a``/``h_s`` and the bottleneck): ``z = h_a(y)``,
    ``(scales, means) = h_s(z_hat)``, y quantized around its means."""

    entropy_structure = "mean_scale"

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        z_hat, z_lik = self.entropy_bottleneck(self.h_a(y), quant_mode, generator)
        scales, means = self.h_s(z_hat).chunk(2, dim=1)
        y_hat, y_lik = gaussian_conditional(
            y, scales, means=means, quant_mode=quant_mode, generator=generator
        )
        return {
            "x_hat": self.g_s(y_hat),
            "y": y,
            "y_hat": y_hat,
            "z_hat": z_hat,
            "scales_hat": scales,
            "means_hat": means,
            "likelihoods": {"y": y_lik, "z": z_lik},
        }


class JointAutoregressive(CodecModel):
    """mbt2018 ("context"): mean-scale hyperprior plus a masked-conv context
    model, in its parallel estimation form.

    y is quantized means-free for the synthesis and the context model
    (``'ste'`` rounds as ``'dequantize'``); its likelihood is the Gaussian's
    at ``entropy_parameters(cat(h_s(z_hat), context))``, scales first and
    means second.  ``transforms`` builds (g_a, g_s, h_a, h_s); the cheng2020
    family overrides it.  ``params_per_latent`` is the entropy-parameters
    head's width over M.
    """

    entropy_structure = "context"
    supports_phase_synthesis = True
    params_per_latent = 2

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a, self.g_s, self.h_a, self.h_s = self.transforms(N, M)
        self.context_prediction = MaskedConv(M, 2 * M)
        self.entropy_parameters = nn.Sequential(
            Conv(M * 12 // 3, M * 10 // 3, 1, 1), nn.LeakyReLU(),
            Conv(M * 10 // 3, M * 8 // 3, 1, 1), nn.LeakyReLU(),
            Conv(M * 8 // 3, M * self.params_per_latent, 1, 1),
        )
        self.entropy_bottleneck = EntropyBottleneck(N)

    @staticmethod
    def transforms(N: int, M: int) -> Tuple[nn.Module, ...]:
        return (_balle_analysis(N, M), _balle_synthesis(N, M)) + _mean_scale_hyper(N, M)

    def y_likelihood(self, y, params, quant_mode: str,
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Result]:
        """Likelihood of y given the entropy parameters, and the extra
        entries of the result."""
        scales, means = params.chunk(2, dim=1)
        _, y_lik = gaussian_conditional(
            y, scales, means=means, quant_mode=quant_mode, generator=generator
        )
        return y_lik, {"scales_hat": scales, "means_hat": means}

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        z = self.h_a(y)
        z_hat, z_lik = self.entropy_bottleneck(z, quant_mode, generator)
        hyper = self.h_s(z_hat)
        y_mode = "dequantize" if quant_mode in ("dequantize", "ste") else quant_mode
        y_hat = quantize(y, y_mode, means=None, generator=generator)
        params = self.entropy_parameters(torch.cat([hyper, self.context_prediction(y_hat)], 1))
        y_lik, extra = self.y_likelihood(y, params, quant_mode, generator)
        return {
            "x_hat": self.g_s(y_hat),
            "y": y,
            "y_hat": y_hat,
            "z_hat": z_hat,
            **extra,
            "likelihoods": {"y": y_lik, "z": z_lik},
        }


class Cheng2020Anchor(JointAutoregressive):
    """cheng2020-anchor: residual-block transforms over the joint
    autoregressive entropy structure (M == N).  Its synthesis ends in a
    ``SubpelConv``, whose conv output is the phase form."""

    def __init__(self, N: int):
        super().__init__(N, N)

    @staticmethod
    def transforms(N: int, M: int) -> Tuple[nn.Module, ...]:
        n = N
        g_a = nn.Sequential(
            ResidualBlockWithStride(3, n), ResidualBlock(n),
            ResidualBlockWithStride(n, n), ResidualBlock(n),
            ResidualBlockWithStride(n, n), ResidualBlock(n),
            Conv(n, n, 3, 2),
        )
        g_s = nn.Sequential(
            ResidualBlock(n), ResidualBlockUpsample(n, n),
            ResidualBlock(n), ResidualBlockUpsample(n, n),
            ResidualBlock(n), ResidualBlockUpsample(n, n),
            ResidualBlock(n), SubpelConv(n, 3),
        )
        h_a = nn.Sequential(
            Conv(n, n, 3, 1), nn.LeakyReLU(), Conv(n, n, 3, 1), nn.LeakyReLU(),
            Conv(n, n, 3, 2), nn.LeakyReLU(), Conv(n, n, 3, 1), nn.LeakyReLU(),
            Conv(n, n, 3, 2),
        )
        h_s = nn.Sequential(
            Conv(n, n, 3, 1), nn.LeakyReLU(), SubpelConv(n, n), nn.LeakyReLU(),
            Conv(n, n * 3 // 2, 3, 1), nn.LeakyReLU(),
            SubpelConv(n * 3 // 2, n * 3 // 2), nn.LeakyReLU(),
            Conv(n * 3 // 2, n * 2, 3, 1),
        )
        return g_a, g_s, h_a, h_s


class Cheng2020Attention(Cheng2020Anchor):
    """cheng2020-attn: the anchor's transforms with attention blocks after
    the second and the last analysis stage (``g_a.attn_1``, ``g_a.attn_2``)
    and before the first and fourth synthesis stage (``g_s.attn_0``,
    ``g_s.attn_1``)."""

    @staticmethod
    def transforms(N: int, M: int) -> Tuple[nn.Module, ...]:
        g_a, g_s, h_a, h_s = Cheng2020Anchor.transforms(N, M)
        ga, gs = list(g_a.named_children()), list(g_s.named_children())
        g_a = nn.Sequential(OrderedDict(
            ga[:3] + [("attn_1", AttentionBlock(N))] + ga[3:] + [("attn_2", AttentionBlock(N))]
        ))
        g_s = nn.Sequential(OrderedDict(
            [("attn_0", AttentionBlock(N))] + gs[:4] + [("attn_1", AttentionBlock(N))] + gs[4:]
        ))
        return g_a, g_s, h_a, h_s


def split_gmm_params(params: torch.Tensor, k: int) -> Tuple[torch.Tensor, ...]:
    """(scales, means, logits), each ``(B, M, H, W, K)``, from the
    ``(B, 3*K*M, H, W)`` head output, whose channels are ordered
    (3, K, M) as the reference's NHWC ``reshape(..., 3, K, M)``."""
    b, c, h, w = params.shape
    m = c // (3 * k)
    params = params.reshape(b, 3, k, m, h, w).permute(0, 1, 3, 4, 5, 2)
    return params[:, 0], params[:, 1], params[:, 2]


class Cheng2020AttnGMM(Cheng2020Attention):
    """The paper's full model: cheng2020-attn transforms with a K-component
    Gaussian-mixture conditional (K=3).  The entropy-parameters head emits
    3*K*N channels: per-component scales, means and mixture logits."""

    K = 3
    params_per_latent = 3 * K
    entropy_structure = "context_gmm"

    def y_likelihood(self, y, params, quant_mode: str,
                     generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Result]:
        scales, means, logits = split_gmm_params(params, self.K)
        _, y_lik = gaussian_mixture_conditional(
            y, scales, means, logits, quant_mode=quant_mode, generator=generator
        )
        return y_lik, {}


class DebugCodec(CodecModel):
    """The reference's one-layer autoencoder fixture: 3x3 stride-1 analysis
    and synthesis over a mean-scale hyper entropy structure.  Its synthesis
    bypasses quantization (``x_hat = g_s(y)``); it has no GDN and no phase
    synthesis."""

    def __init__(self, N: int = 3, M: int = 192):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = nn.Sequential(Conv(3, M, 3, 1))
        self.g_s = nn.Sequential(Deconv(M, 3, 3, 1))
        self.h_a, self.h_s = _mean_scale_hyper(N, M)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def from_latent(self, y, quant_mode: str = "noise",
                    generator: Optional[torch.Generator] = None) -> Result:
        z_hat, z_lik = self.entropy_bottleneck(self.h_a(y), quant_mode, generator)
        scales, means = self.h_s(z_hat).chunk(2, dim=1)
        y_hat, y_lik = gaussian_conditional(
            y, scales, means=means, quant_mode=quant_mode, generator=generator
        )
        return {
            "x_hat": self.g_s(y),
            "y": y,
            "y_hat": y_hat,
            "z_hat": z_hat,
            "likelihoods": {"y": y_lik, "z": z_lik},
        }
