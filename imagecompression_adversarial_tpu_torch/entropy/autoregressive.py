"""Coding in decode order for the autoregressive context models (port of
``imagecompression_adversarial_tpu/entropy/autoregressive.py``).

The real coder of mbt2018 ("context"), cheng2020 and cheng2020-gmm: each
latent pixel's entropy parameters depend on already decoded neighbours
through the masked 5x5 context conv, so decoding is sequential.  With the
raster-causal mask, pixel (i, j) depends only on pixels with
``3*i' + j' < 3*i + j``, so every anti-diagonal ``t = 3*i + j`` (a
wavefront) is one batch: a (h, w) latent takes ``3*h + w - 3`` steps.

The head runs in torch on the codec's device: the gather of the 12 causal
taps from a padded device canvas, the context product, the image-wide
hyper half of the first entropy-parameters layer (hoisted out of the loop),
two more products and the leaky ReLUs.  Only each front's (P, M) scales and
means (and the mixture's logits) go to the host, for the CDF rows and the
rANS call; decoded symbols go back onto the canvas.

Encoder and decoder must compute the same floats, or the decoder picks
other CDF rows.  Both run the same torch calls on batches composed the same
way, front by front, on one kind of device with the same settings
(``codec.coder_settings``).  The encoder needs no symbol on the host before
the end, so it runs every front on the device and copies once; the decoder
copies each front's parameters and waits for them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .rans import StreamingDecoder, encode_with_indexes
from .tables import build_gmm_cdf_rows, gc_build_indexes, ideal_bits, stack_rows

_SLOPE = 0.01  # the entropy-parameters head's leaky ReLU


def wavefronts(h: int, w: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(i, j) index arrays of each anti-diagonal ``t = 3*i + j``, ascending
    in t, each in ascending i."""
    ii, jj = np.mgrid[0:h, 0:w]
    t = (3 * ii + jj).ravel()
    order = np.argsort(t, kind="stable")
    ts, iis, jjs = t[order], ii.ravel()[order], jj.ravel()[order]
    bounds = np.searchsorted(ts, np.arange(ts[-1] + 2))
    return [(iis[a:b], jjs[a:b]) for a, b in zip(bounds[:-1], bounds[1:]) if a < b]


class ARWeights:
    """The context model's weights as matrices on the module's device.

    ``gmm_k`` is the mixture's K for ``context_gmm`` (a head of 3*K*M
    channels, ordered (3, K, M)), else 0 (scales and means).
    """

    def __init__(self, module):
        cp = module.context_prediction
        mask = cp.mask[0, 0]
        kernel = (cp.weight * cp.mask).detach()  # (C_ctx, M, 5, 5)
        c_ctx, m = kernel.shape[:2]
        # the mask keeps 12 of 25 taps (rows above, left of centre);
        # contracting those alone halves the context product
        ti, tj = torch.nonzero(mask, as_tuple=True)
        self.tap_i, self.tap_j = ti, tj
        self.ctx_kernel_taps = kernel[:, :, ti, tj].permute(2, 1, 0).reshape(-1, c_ctx).contiguous()
        self.ctx_bias = cp.bias.detach()
        convs = [module.entropy_parameters[i] for i in (0, 2, 4)]
        self.ep = [(c.weight[:, :, 0, 0].t().detach().contiguous(), c.bias.detach())
                   for c in convs]
        # the first layer takes cat(hyper, ctx): its hyper half does not
        # depend on the canvas and is applied once over the whole image
        w0, b0 = self.ep[0]
        self.ep0_hyper, self.ep0_ctx = w0[:-c_ctx], w0[-c_ctx:]
        self.ep0_bias = b0
        self.m = m
        self.gmm_k = module.K if module.entropy_structure == "context_gmm" else 0

    def precompute_hyper(self, hyper: torch.Tensor) -> torch.Tensor:
        """``h_s`` output (1, F, h, w) -> (h, w, C0): the hyper half of the
        first layer, its bias and the context bias through it."""
        _, f, h, w = hyper.shape
        base = hyper[0].permute(1, 2, 0).reshape(-1, f) @ self.ep0_hyper + self.ep0_bias
        base = base + self.ctx_bias @ self.ep0_ctx
        return base.reshape(h, w, -1)

    def head_from_pre(self, taps: torch.Tensor, pre: torch.Tensor):
        """``taps`` (P, T, M) causal neighbourhoods, ``pre`` (P, C0) the
        hyper half.  Single Gaussian: (scales, means), each (P, M); mixture:
        (scales, means, logits), each (P, M, K)."""
        p = taps.shape[0]
        ctx = taps.reshape(p, -1) @ self.ctx_kernel_taps
        feat = F.leaky_relu(pre + ctx @ self.ep0_ctx, _SLOPE)
        (w1, b1), (w2, b2) = self.ep[1:]
        feat = F.leaky_relu(feat @ w1 + b1, _SLOPE)
        feat = feat @ w2 + b2
        if self.gmm_k:
            g = feat.reshape(p, 3, self.gmm_k, self.m).permute(0, 3, 2, 1)
            return g[..., 0], g[..., 1], g[..., 2]
        scales, means = feat.chunk(2, dim=1)
        return scales, means


class _Wavefronts:
    """The padded (h+4, w+4, M) canvas on the device, the fronts as device
    index tensors, and the head's parameters of a front."""

    PAD = 2

    def __init__(self, hyper: torch.Tensor, weights: ARWeights):
        _, _, self.h, self.w = hyper.shape
        device = hyper.device
        self.weights = weights
        self.canvas = torch.zeros(self.h + 2 * self.PAD, self.w + 2 * self.PAD, weights.m,
                                  device=device)
        fronts = wavefronts(self.h, self.w)
        self.sizes = [len(i) for i, _ in fronts]
        ii = torch.from_numpy(np.concatenate([i for i, _ in fronts])).to(device)
        jj = torch.from_numpy(np.concatenate([j for _, j in fronts])).to(device)
        self.fronts = list(zip(ii.split(self.sizes), jj.split(self.sizes)))
        self.pre = weights.precompute_hyper(hyper)

    def params_for(self, ii: torch.Tensor, jj: torch.Tensor):
        rows = ii[:, None] + self.weights.tap_i[None, :]
        cols = jj[:, None] + self.weights.tap_j[None, :]
        return self.weights.head_from_pre(self.canvas[rows, cols], self.pre[ii, jj])

    def place(self, ii: torch.Tensor, jj: torch.Tensor, values: torch.Tensor) -> None:
        self.canvas[ii + self.PAD, jj + self.PAD] = values

    def result(self) -> torch.Tensor:
        """The decoded latent, (1, M, h, w) in channels_last."""
        inner = self.canvas[self.PAD:self.PAD + self.h, self.PAD:self.PAD + self.w]
        return inner.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)


def _latent_rows(y: torch.Tensor) -> torch.Tensor:
    """(1, M, h, w) -> an (h, w, M) view."""
    return y[0].permute(1, 2, 0)


def ar_encode(y: torch.Tensor, hyper: torch.Tensor, weights: ARWeights, gc_tables: Dict,
              stats: Optional[Dict] = None) -> Tuple[bytes, torch.Tensor]:
    """Encode ``y`` (1, M, h, w) given ``hyper = h_s(z_hat)`` (1, F, h, w)
    with the scale-table rows; the symbols are ``round(y - means)``.
    Returns the string and the encoder's latent ``sym + means``.  ``stats``,
    when given, receives ``ideal_bits`` and, in coding order, ``symbols``,
    ``indexes``, ``values`` (``y - means``) and ``scales``."""
    run = _Wavefronts(hyper, weights)
    y_rows = _latent_rows(y)
    coded = []
    for ii, jj in run.fronts:
        scales, means = run.params_for(ii, jj)
        values = y_rows[ii, jj] - means
        sym = torch.round(values)
        run.place(ii, jj, sym + means)
        coded.append(torch.stack([scales, sym, values]))
    scales, sym, values = torch.cat(coded, dim=1).cpu().numpy().reshape(3, -1)
    symbols = sym.astype(np.int32)
    indexes = gc_build_indexes(scales, gc_tables["scale_table"])
    tables = (gc_tables["cdfs"], gc_tables["cdf_sizes"], gc_tables["offsets"])
    if stats is not None:
        stats.update(ideal_bits=ideal_bits(symbols, indexes, *tables), symbols=symbols,
                     indexes=indexes, values=values, scales=scales)
    return encode_with_indexes(symbols, indexes, *tables), run.result()


def ar_decode(string: bytes, hyper: torch.Tensor, weights: ARWeights,
              gc_tables: Dict) -> torch.Tensor:
    """Decode to the latent (1, M, h, w); single-Gaussian path."""
    run = _Wavefronts(hyper, weights)
    tables = (gc_tables["cdfs"], gc_tables["cdf_sizes"], gc_tables["offsets"])
    with StreamingDecoder(string) as dec:
        for ii, jj in run.fronts:
            scales, means = run.params_for(ii, jj)
            idx = gc_build_indexes(scales.cpu().numpy(), gc_tables["scale_table"]).ravel()
            sym = dec.decode(idx, *tables).reshape(means.shape).astype(np.float32)
            run.place(ii, jj, torch.from_numpy(sym).to(means.device) + means)
    return run.result()


def ar_encode_gmm(y: torch.Tensor, hyper: torch.Tensor, weights: ARWeights,
                  stats: Optional[Dict] = None) -> Tuple[bytes, torch.Tensor]:
    """Encode with one mixture CDF row a symbol, built front by front as
    the decoder builds them.  The symbols are ``round(y)``: the estimation
    path quantizes means-free.  Returns the string and the latent; ``stats``
    as in :func:`ar_encode`, with ``scales`` (N, K), the rows (``cdfs``,
    ``cdf_sizes``, ``offsets``) and ``indexes`` the identity."""
    if not weights.gmm_k:
        raise ValueError("ar_encode_gmm needs the weights of a mixture head")
    run = _Wavefronts(hyper, weights)
    y_rows = _latent_rows(y)
    params, coded = [], []
    for ii, jj in run.fronts:
        scales, means, logits = run.params_for(ii, jj)
        values = y_rows[ii, jj]
        sym = torch.round(values)
        run.place(ii, jj, sym)
        params.append(torch.stack([scales, means, logits]).reshape(3, -1, weights.gmm_k))
        coded.append(torch.stack([sym, values]).reshape(2, -1))
    params = torch.cat(params, dim=1).cpu().numpy()
    sym, values = torch.cat(coded, dim=1).cpu().numpy()
    rows, sizes, offsets = [], [], []
    pos = 0
    for n in run.sizes:
        r, s, o = build_gmm_cdf_rows(*params[:, pos:pos + n * weights.m])
        rows.append(r)
        sizes.append(s)
        offsets.append(o)
        pos += n * weights.m
    symbols = sym.astype(np.int32)
    tables = (stack_rows(rows), np.concatenate(sizes), np.concatenate(offsets))
    indexes = np.arange(symbols.size, dtype=np.int32)
    if stats is not None:
        stats.update(ideal_bits=ideal_bits(symbols, indexes, *tables), symbols=symbols,
                     indexes=indexes, values=values, scales=params[0], cdfs=tables[0],
                     cdf_sizes=tables[1], offsets=tables[2])
    return encode_with_indexes(symbols, indexes, *tables), run.result()


def ar_decode_gmm(string: bytes, hyper: torch.Tensor, weights: ARWeights) -> torch.Tensor:
    """Decode the mixture stream to the latent (1, M, h, w)."""
    if not weights.gmm_k:
        raise ValueError("ar_decode_gmm needs the weights of a mixture head")
    run = _Wavefronts(hyper, weights)
    with StreamingDecoder(string) as dec:
        for ii, jj in run.fronts:
            params = torch.stack(run.params_for(ii, jj)).cpu().numpy()
            rows, sizes, offsets = build_gmm_cdf_rows(*params)
            sym = dec.decode(np.arange(sizes.size, dtype=np.int32), rows, sizes, offsets)
            run.place(ii, jj, torch.from_numpy(sym.reshape(len(ii), weights.m).astype(np.float32))
                      .to(run.canvas.device))
    return run.result()
