"""The port's wavefront coder for the context models
(``entropy/autoregressive.py``) vs the JAX package's, on the CPU.

Weights: context q1 seeded in the port and handed to JAX with its own
``convert_state_dict``; cheng2020-gmm q3 from the committed demo
checkpoint on both sides.  Latents and hyper features are numpy arrays made
from a seed.

* ``wavefronts`` equal JAX's exactly, and every causal tap of a pixel lies
  on an earlier front.
* The head (``precompute_hyper`` and ``head_from_pre``) is within atol
  1e-5 of JAX's on the same taps (float32 products summed in another
  order).
* ``ar_encode``/``ar_encode_gmm``: the port's bytes equal JAX's where the
  symbols, indexes and rows are equal.  A symbol may round the other way
  within 1e-4 of a half-integer and an index may pick the next row within
  1e-5 (relative) of a scale-table boundary (``torch_coder_diff``); the
  counts of differing symbols, indexes and row entries are printed.
  cheng2020-gmm builds a row a symbol in float64 from float32 head outputs
  that differ in the last bits, so a quantized frequency at a rounding
  boundary moves by one count (504 of 614,400 entries on these inputs):
  its rows must agree within one count, sizes and offsets exactly, and its
  stream's length within 1% of JAX's.
* Decoding reproduces the encoder's latent exactly.
"""

import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.entropy import autoregressive as j_ar
from imagecompression_adversarial_tpu.entropy.tables import build_gc_tables as j_build_gc_tables
from imagecompression_adversarial_tpu.io.convert import convert_state_dict
from imagecompression_adversarial_tpu_torch.config import Config
from imagecompression_adversarial_tpu_torch.entropy import autoregressive as ar
from imagecompression_adversarial_tpu_torch.entropy.tables import SCALE_TABLE, build_gc_tables
from imagecompression_adversarial_tpu_torch.models import init_model
from imagecompression_adversarial_tpu_torch.runtime import load_model
from torch_coder_diff import compare_streams, table_differences

CKPT_GMM = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo",
                        "cheng2020-gmm-q3-mse-synthetic.msgpack")
HEAD_ATOL = 1e-5
_J_ENCODE = j_ar.encode_with_indexes
_WEIGHTS = {}


def _weights(fam):
    """(port ARWeights, JAX ARWeights) on the same weights."""
    if fam not in _WEIGHTS:
        if fam == "gmm":
            model = load_model(Config(device="cpu", model="cheng2020-gmm", quality=3,
                                      checkpoint=CKPT_GMM))
            with open(CKPT_GMM, "rb") as f:
                jp = flax.serialization.msgpack_restore(f.read())
        else:
            model = init_model("context", 1, seed=3).requires_grad_(False)
            jp = convert_state_dict(model.state_dict(), "context")
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
        _WEIGHTS[fam] = (ar.ARWeights(model), j_ar.ARWeights(jp, gmm_k=3 if fam == "gmm" else 0))
    return _WEIGHTS[fam]


def _inputs(weights, h=6, w=7, seed=0):
    """Seeded y (h, w, M) and hyper features (h, w, F), NHWC numpy."""
    rng = np.random.RandomState(seed)
    y = (rng.randn(h, w, weights.m) * 3).astype(np.float32)
    hyper = (rng.randn(h, w, weights.ep0_hyper.shape[0]) * 0.5).astype(np.float32)
    return y, hyper


def _nchw(a):
    return torch.from_numpy(a).permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("h, w", [(1, 1), (1, 9), (4, 7), (6, 3), (32, 48)])
def test_wavefronts_equal_jax_and_causal(h, w):
    ours, theirs = ar.wavefronts(h, w), j_ar.wavefronts(h, w)
    assert len(ours) == len(theirs) == 3 * (h - 1) + w
    step = np.full((h, w), -1)
    for t, ((i, j), (ji, jj)) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(j, jj)
        assert (step[i, j] == -1).all()
        step[i, j] = t
    assert (step >= 0).all()
    weights, _ = _weights("context")
    for di, dj in zip(weights.tap_i.numpy() - 2, weights.tap_j.numpy() - 2):
        # every causal neighbour inside the latent comes on an earlier front
        src = step[max(0, -di):h - max(0, di), max(0, -dj):w - max(0, dj)]
        dst = step[max(0, di):h + min(0, di), max(0, dj):w + min(0, dj)]
        assert (src > dst).all() if src.size else True


@pytest.mark.parametrize("fam", ["context", "gmm"])
def test_head_matches_jax(fam):
    ours, theirs = _weights(fam)
    np.testing.assert_array_equal(ours.tap_i.numpy(), theirs.tap_i)
    np.testing.assert_array_equal(ours.tap_j.numpy(), theirs.tap_j)
    y, hyper = _inputs(theirs)
    pre_j = theirs.precompute_hyper(hyper)
    pre = ours.precompute_hyper(_nchw(hyper))
    np.testing.assert_allclose(pre.numpy(), pre_j, atol=HEAD_ATOL, rtol=0)
    rng = np.random.RandomState(1)
    taps = np.round(rng.randn(40, theirs.tap_i.size, theirs.m) * 3).astype(np.float32)
    rows = pre_j.reshape(-1, pre_j.shape[-1])[:40]
    for a, b in zip(ours.head_from_pre(torch.from_numpy(taps), torch.from_numpy(rows)),
                    theirs.head_from_pre(taps, rows)):
        np.testing.assert_allclose(a.numpy(), b, atol=HEAD_ATOL, rtol=0)


def _jax_encode(fam, theirs, y, hyper, monkeypatch):
    """JAX's bytes and what it handed the coder."""
    seen = {}

    def capture(symbols, indexes, cdfs, cdf_sizes, offsets):
        seen.update(symbols=np.asarray(symbols), indexes=np.asarray(indexes), cdfs=cdfs,
                    cdf_sizes=cdf_sizes, offsets=offsets)
        return _J_ENCODE(symbols, indexes, cdfs, cdf_sizes, offsets)

    monkeypatch.setattr(j_ar, "encode_with_indexes", capture)
    if fam == "gmm":
        data = j_ar.ar_encode_gmm(y, hyper, theirs)
    else:
        data = j_ar.ar_encode(y, hyper, theirs, j_build_gc_tables())
    return data, seen


@pytest.mark.parametrize("fam", ["context", "gmm"])
def test_ar_encode_bytes_match_jax(fam, monkeypatch):
    ours, theirs = _weights(fam)
    y, hyper = _inputs(theirs, h=8, w=10, seed=2)
    data_j, seen = _jax_encode(fam, theirs, y, hyper, monkeypatch)
    stats = {}
    if fam == "gmm":
        data, _ = ar.ar_encode_gmm(_nchw(y), _nchw(hyper), ours, stats=stats)
    else:
        data, _ = ar.ar_encode(_nchw(y), _nchw(hyper), ours, build_gc_tables(), stats=stats)
    counts = compare_streams([("y", stats, seen)], SCALE_TABLE)
    rows = table_differences(stats, seen) if fam == "gmm" else {}
    print(f"{fam}: {counts['symbols']} symbols and {counts['indexes']} indexes of "
          f"{counts['total']} differ (first {counts['first']}); rows {rows}")
    assert counts["symbols"] + counts["indexes"] <= 1e-3 * counts["total"]
    if counts["symbols"] == counts["indexes"] == 0 and not any(n for n, _ in rows.values()):
        assert data == data_j
    if fam == "gmm":
        assert rows["cdf_sizes"] == rows["offsets"] == (0, 0)
        assert rows["cdfs"][1] is not None and rows["cdfs"][1] <= 1
        assert abs(len(data) / len(data_j) - 1.0) <= 0.01


@pytest.mark.parametrize("fam", ["context", "gmm"])
def test_ar_decode_reproduces_encoder_canvas(fam):
    ours, _ = _weights(fam)
    y, hyper = _inputs(ours, h=5, w=9, seed=3)
    y, hyper = _nchw(y), _nchw(hyper)
    if fam == "gmm":
        data, latent = ar.ar_encode_gmm(y, hyper, ours)
        decoded = ar.ar_decode_gmm(data, hyper, ours)
        np.testing.assert_array_equal(latent.numpy(), torch.round(y).numpy())
    else:
        tables = build_gc_tables()
        data, latent = ar.ar_encode(y, hyper, ours, tables)
        decoded = ar.ar_decode(data, hyper, ours, tables)
        assert (latent - y).abs().max() <= 0.5 + 1e-5  # half a bin from y
    assert decoded.shape == latent.shape == y.shape
    assert torch.equal(decoded, latent)
