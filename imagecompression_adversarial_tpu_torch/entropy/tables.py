"""Quantized CDF tables for the rANS coder (port of
``imagecompression_adversarial_tpu/entropy/tables.py``).

The tables are numpy on the host, computed in float64 with scipy's
``norm``/``erf`` as in the JAX package, so that the same float32 inputs give
the same integer rows entry for entry.  Only ``build_eb_tables`` evaluates a
model: the port's ``EntropyBottleneck`` on its own device.

* ``pmf_to_quantized_cdf(_batch)``: 16-bit quantization with a nonzero
  escape slot; the excess or deficit goes to the largest entries.
* ``build_eb_tables``: each channel's pmf of the factorized model on the
  integer lattice its learned quantiles span.
* ``build_gc_tables``: the conditional Gaussian's pmf for each of the 64
  scales of ``SCALE_TABLE``; ``gc_build_indexes`` maps scales to rows.
* ``build_gmm_cdf_rows``: one row per symbol for Gaussian mixtures.
* ``ideal_bits``: the cost of exactly these symbols under exactly these
  rows, escape and bypass included.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from scipy import special, stats

from .factorized import EntropyBottleneck
from .gaussian import SCALE_BOUND

PRECISION = 16
_SCALE = 1 << PRECISION
# the probability a Gaussian row leaves outside its support (escape-coded)
_TAIL_MASS = 1e-9
_GMM_TAIL_SIGMA = 6.0
_GMM_MAX_SUPPORT = 192

#: The 64 scales of the conditional Gaussian's tables: the JAX package's
#: ``default_scale_table()``, exp of a float32 linspace from log(0.11) to
#: log(256), as it evaluates in float32.  The rows, and so the bitstream,
#: depend on every bit of these values, which exp and linspace round
#: differently from one library to the next, so they are fixed here.
SCALE_TABLE = np.array([
    0.11, 0.124404095, 0.14069438, 0.15911779, 0.17995366, 0.20351797, 0.23016793,
    0.26030758, 0.29439393, 0.3329438, 0.37654155, 0.4258483, 0.4816116, 0.54467696,
    0.61600035, 0.6966635, 0.787889, 0.8910603, 1.0077413, 1.1397015, 1.2889411,
    1.4577236, 1.648607, 1.8644863, 2.1086342, 2.3847523, 2.697027, 3.0501928,
    3.4496047, 3.9013178, 4.4121814, 4.9899406, 5.643356, 6.3823323, 7.218076,
    8.163257, 9.232205, 10.441132, 11.808359, 13.354621, 15.103359, 17.081089,
    19.317799, 21.847393, 24.70823, 27.94369, 31.602812, 35.741085, 40.421257,
    45.71427, 51.70039, 58.470367, 66.12686, 74.78591, 84.57887, 95.65419,
    108.17973, 122.3455, 138.36623, 156.48474, 176.97588, 200.15018, 226.35916, 256.0,
], np.float32)


def pmf_to_quantized_cdf(pmf: np.ndarray, tail_mass: float) -> np.ndarray:
    """Quantize ``[pmf..., tail_mass]`` to an integer CDF ending at 2^16.
    Every slot, the escape included, keeps a frequency >= 1."""
    probs = np.concatenate([np.asarray(pmf, np.float64), [max(tail_mass, 0.0)]])
    probs = np.maximum(probs, 0.0)
    total = probs.sum()
    if total <= 0:
        probs = np.ones_like(probs)
        total = probs.sum()
    freqs = np.round(probs / total * _SCALE).astype(np.int64)
    freqs = np.maximum(freqs, 1)
    diff = _SCALE - freqs.sum()
    while diff != 0:
        if diff > 0:
            freqs[np.argmax(freqs)] += diff
            diff = 0
        else:
            # steal from the largest entry, keeping it >= 1
            i = int(np.argmax(freqs))
            take = min(-diff, freqs[i] - 1)
            freqs[i] -= take
            diff += take
            if take == 0:
                raise ValueError("cannot normalize pmf to 2^16")
    cdf = np.zeros(len(freqs) + 1, np.uint32)
    cdf[1:] = np.cumsum(freqs)
    return cdf


def pmf_to_quantized_cdf_batch(pmfs: np.ndarray, tails: np.ndarray) -> np.ndarray:
    """:func:`pmf_to_quantized_cdf` over R rows: ``pmfs`` (R, S), ``tails``
    (R,) -> (R, S + 2) uint32 rows (S symbols, the escape, the final 2^16)."""
    pmfs = np.asarray(pmfs, np.float64)
    r, s = pmfs.shape
    probs = np.concatenate(
        [np.maximum(pmfs, 0.0), np.maximum(tails, 0.0).reshape(r, 1)], axis=1
    )
    total = probs.sum(axis=1, keepdims=True)
    bad = total[:, 0] <= 0
    if bad.any():
        probs[bad] = 1.0
        total = probs.sum(axis=1, keepdims=True)
    freqs = np.round(probs / total * _SCALE).astype(np.int64)
    freqs = np.maximum(freqs, 1)
    diff = _SCALE - freqs.sum(axis=1)
    # each row's largest entry absorbs its excess or deficit; the rare rows
    # whose largest entry cannot take it all go round again
    for _ in range(s + 2):
        todo = diff != 0
        if not todo.any():
            break
        idx = np.argmax(freqs, axis=1)
        rows_i = np.nonzero(todo)[0]
        take = diff[rows_i]
        cap = freqs[rows_i, idx[rows_i]] - 1
        adj = np.where(take > 0, take, np.maximum(take, -cap))
        freqs[rows_i, idx[rows_i]] += adj
        diff[rows_i] -= adj
    if (diff != 0).any():
        raise ValueError("cannot normalize pmf batch to 2^16")
    cdf = np.zeros((r, s + 2), np.uint32)
    cdf[:, 1:] = np.cumsum(freqs, axis=1)
    return cdf


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + special.erf(x / np.sqrt(2.0)))


def build_gmm_cdf_rows(scales: np.ndarray, means: np.ndarray, logits: np.ndarray) -> tuple:
    """One CDF row per symbol for K-component Gaussian mixtures.

    ``scales``/``means``/``logits`` (..., K) flatten to R rows.  Every row
    spans the same number of symbols, from ``floor(min_k mu_k) - T`` with
    ``T = ceil(6 * max_k sigma_k)``, as wide as the batch's widest row
    needs and at most 192; the escape codes what falls outside.  Returns
    (cdfs (R, S+2) uint32, sizes (R,) int32, offsets (R,) int32).
    """
    k = scales.shape[-1]
    sc = np.maximum(np.asarray(scales, np.float64).reshape(-1, k), SCALE_BOUND)
    mu = np.asarray(means, np.float64).reshape(-1, k)
    lg = np.asarray(logits, np.float64).reshape(-1, k)
    w = np.exp(lg - lg.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)

    t = np.ceil(_GMM_TAIL_SIGMA * sc.max(axis=1))
    lo = np.floor(mu.min(axis=1) - t).astype(np.int64)
    hi = np.ceil(mu.max(axis=1) + t).astype(np.int64)
    width = min(int((hi - lo).max()) + 1, _GMM_MAX_SUPPORT)
    v = lo[:, None] + np.arange(width)[None, :]  # (R, W) symbol values
    upper = _norm_cdf((v[..., None] + 0.5 - mu[:, None, :]) / sc[:, None, :])
    lower = _norm_cdf((v[..., None] - 0.5 - mu[:, None, :]) / sc[:, None, :])
    pmf = np.einsum("rwk,rk->rw", upper - lower, w)
    tails = np.maximum(1.0 - pmf.sum(axis=1), 0.0)
    cdfs = pmf_to_quantized_cdf_batch(pmf, tails)
    sizes = np.full(lo.shape, width + 1, np.int32)  # + the escape slot
    return cdfs, sizes, lo.astype(np.int32)


def stack_rows(rows) -> np.ndarray:
    """Stack CDF rows (1-D, or 2-D blocks of rows) of different lengths
    into one (R, stride) uint32 matrix, each row padded with its last
    entry."""
    blocks = [np.atleast_2d(r) for r in rows]
    stride = max(b.shape[1] for b in blocks)
    out = np.empty((sum(b.shape[0] for b in blocks), stride), np.uint32)
    pos = 0
    for b in blocks:
        n, s = b.shape
        out[pos:pos + n, :s] = b
        out[pos:pos + n, s:] = b[:, -1:]
        pos += n
    return out


@torch.no_grad()
def build_eb_tables(eb: EntropyBottleneck) -> Dict[str, np.ndarray]:
    """CDF tables of an ``EntropyBottleneck``, its model evaluated on its own
    device: {cdfs, cdf_sizes, offsets, medians} (numpy)."""
    device = eb.quantiles.device
    quantiles = eb.quantiles.detach().cpu().numpy()  # (C, 1, 3)
    medians = quantiles[:, 0, 1]
    minima = np.maximum(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64), 0)
    maxima = np.maximum(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64), 0)

    # every channel on one lattice as long as the longest, cut per channel
    max_len = int((minima + maxima).max()) + 1
    start = (medians - minima).astype(np.float32)
    grid = start[:, None] + np.arange(max_len, dtype=np.float32)[None, :]
    end = start + (minima + maxima).astype(np.float32)

    def model(fn, values: np.ndarray) -> np.ndarray:
        return fn(torch.from_numpy(values).to(device)).cpu().numpy()[:, 0]

    lik = model(eb.likelihood, grid[:, None, :])
    lower_logit = model(eb.logits_cumulative, (start - 0.5)[:, None, None])[:, 0]
    upper_logit = model(eb.logits_cumulative, (end + 0.5)[:, None, None])[:, 0]
    # each channel's tail mass from the CDF logits at the lattice's ends
    tails = 1.0 / (1.0 + np.exp(-lower_logit)) + 1.0 / (1.0 + np.exp(upper_logit))

    rows = [
        pmf_to_quantized_cdf(lik[ch, : int(minima[ch] + maxima[ch]) + 1], float(tails[ch]))
        for ch in range(quantiles.shape[0])
    ]
    return {
        "cdfs": stack_rows(rows),
        "cdf_sizes": np.array([len(r) - 1 for r in rows], np.int32),
        "offsets": (-minima).astype(np.int32),
        "medians": medians.astype(np.float32),
    }


def build_gc_tables() -> Dict[str, np.ndarray]:
    """CDF tables of the conditional Gaussian, one row a scale of
    ``SCALE_TABLE``."""
    scale_table = SCALE_TABLE.astype(np.float64)
    multiplier = -stats.norm.ppf(_TAIL_MASS / 2.0)
    centers = np.ceil(scale_table * multiplier).astype(np.int64)
    rows = []
    for s, center in zip(scale_table, centers):
        v = np.arange(-center, center + 1, dtype=np.float64)
        pmf = stats.norm.cdf((v + 0.5) / s) - stats.norm.cdf((v - 0.5) / s)
        tail = 2.0 * stats.norm.cdf((-0.5 - center) / s)
        rows.append(pmf_to_quantized_cdf(pmf, tail))
    return {
        "cdfs": stack_rows(rows),
        "cdf_sizes": np.array([len(r) - 1 for r in rows], np.int32),
        "offsets": (-centers).astype(np.int32),
        "scale_table": scale_table.astype(np.float32),
    }


def gc_build_indexes(scales: np.ndarray, scale_table: np.ndarray) -> np.ndarray:
    """Row of each scale: the smallest i with scale <= scale_table[i]
    (CompressAI's rule), scales floored at SCALE_BOUND."""
    scales = np.maximum(np.asarray(scales, np.float64), SCALE_BOUND)
    return np.searchsorted(scale_table[:-1], scales, side="left").astype(np.int32)


def ideal_bits(symbols, indexes, cdfs, cdf_sizes, offsets) -> float:
    """Bits that coding ``symbols`` with these rows ideally costs, with the
    coder's escape and bypass scheme (``csrc/rans.cc``): a symbol in the
    alphabet costs -log2 of its quantized probability; one outside costs
    the escape plus 4 bits for each bypass chunk.  Real bytes less this is
    the coder's overhead.  Not a floor for one sequence: with 16-bit
    probabilities the truncating state update can spend up to ~1 bit less
    than -log2(p) on a likely symbol (~0.05 bits a symbol below on a peaked
    random-weight stream); the bound holds in expectation."""
    symbols = np.asarray(symbols).ravel()
    indexes = np.asarray(indexes).ravel()
    max_sym = cdf_sizes[indexes] - 1  # the escape slot of each row
    value = symbols - offsets[indexes]
    neg = value < 0
    pos = value >= max_sym
    bypass_val = np.where(neg, -2 * value - 1, np.where(pos, 2 * (value - max_sym), 0))
    slot = np.where(neg | pos, max_sym, value)
    p = (cdfs[indexes, slot + 1].astype(np.float64) - cdfs[indexes, slot]) / float(_SCALE)
    bits = -np.log2(np.maximum(p, 2.0 ** -PRECISION))
    # 4-bit chunks: a chunk of 15 continues, the last one (< 15) stops
    bits += np.where(neg | pos, 4.0 * (bypass_val // 15 + 1), 0.0)
    return float(bits.sum())
