"""The port's rANS coder (``csrc/rans.cc``, ``entropy/rans.py``) and CDF
tables (``entropy/tables.py``) vs the JAX package's, on the CPU.

* The coder: the same symbols, indexes and tables give identical bytes on
  both sides (escape and bypass overflow, offsets, several rows), each side
  decodes the other's, and the streaming decoder decodes in chunks with
  tables of its own for each chunk.
* The tables are numpy/scipy in float64 on both sides: equal entry for
  entry, indexes equal, ``ideal_bits`` equal.
* ``build_eb_tables`` evaluates the factorized model in float32, the port
  in torch and JAX in XLA, whose likelihoods differ in the last bits: sizes,
  offsets and medians are equal and each CDF entry is within one count (the
  number of entries that differ is printed).
* The g++ build lands in ``_build/`` under its hash and loads.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from imagecompression_adversarial_tpu.entropy import rans as j_rans
from imagecompression_adversarial_tpu.entropy import tables as j_tables
from imagecompression_adversarial_tpu.entropy.gaussian import default_scale_table
from imagecompression_adversarial_tpu_torch.entropy import rans, tables
from imagecompression_adversarial_tpu_torch.entropy.factorized import EntropyBottleneck
from imagecompression_adversarial_tpu_torch.io.weights import params_from_jax, read_msgpack
from imagecompression_adversarial_tpu_torch.kernels import _build

CKPT = os.path.join(os.path.dirname(__file__), "..", "ckpts", "demo", "hyper-q1-mse-synthetic.msgpack")


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _case(name):
    """(symbols, indexes, cdfs, sizes, offsets) of a coding case."""
    rng = np.random.RandomState(0)
    if name == "one_row":
        pmf = np.array([0.2, 0.3, 0.25, 0.15, 0.05])
        cdf = tables.pmf_to_quantized_cdf(pmf, 0.05)
        symbols = rng.choice(5, size=5000, p=pmf / pmf.sum())
        return _i32(symbols), _i32(np.zeros(5000)), cdf[None], _i32([len(cdf) - 1]), _i32([0])
    if name == "overflow":
        # values far outside the alphabet: escape plus bypass chunks
        cdf = tables.pmf_to_quantized_cdf(np.array([0.45, 0.45]), 0.1)
        symbols = _i32([-3, -2, 47, -40, 5, -3, 200, -3, -1000, 1000])
        return symbols, _i32(np.zeros(10)), cdf[None], _i32([len(cdf) - 1]), _i32([-3])
    rows = [tables.pmf_to_quantized_cdf(rng.dirichlet(np.ones(6 + k)), 1e-3) for k in range(4)]
    sizes, offsets = _i32([len(r) - 1 for r in rows]), _i32([-k for k in range(4)])
    indexes = _i32(rng.randint(0, 4, 3000))
    # mostly in the alphabet, every 50th symbol far outside it
    symbols = np.array([rng.randint(0, sizes[i] - 1) + offsets[i] for i in indexes])
    symbols[::50] += rng.choice([-1, 1], symbols[::50].size) * rng.randint(20, 90, symbols[::50].size)
    return _i32(symbols), indexes, tables.stack_rows(rows), sizes, offsets


@pytest.mark.parametrize("name", ["one_row", "overflow", "multi_row"])
def test_rans_bytes_equal_jax(name):
    symbols, indexes, cdfs, sizes, offsets = _case(name)
    ours = rans.encode_with_indexes(symbols, indexes, cdfs, sizes, offsets)
    theirs = j_rans.encode_with_indexes(symbols, indexes, cdfs, sizes, offsets)
    assert ours == theirs
    np.testing.assert_array_equal(rans.decode_with_indexes(ours, indexes, cdfs, sizes, offsets),
                                  symbols)
    np.testing.assert_array_equal(j_rans.decode_with_indexes(ours, indexes, cdfs, sizes, offsets),
                                  symbols)


def test_streaming_decode_in_chunks_with_own_tables():
    """Chunks of 1 to 97 symbols, each coded with one row a symbol built for
    that chunk (the GMM coder's scheme); the one-shot decode agrees."""
    rng = np.random.RandomState(1)
    chunks, rows, sizes, offsets, symbols = [], [], [], [], []
    n = 0
    for size in (1, 5, 97, 2, 40, 64):
        scales = np.exp(rng.randn(size, 3)).astype(np.float32)
        means = (rng.randn(size, 3) * 3).astype(np.float32)
        logits = rng.randn(size, 3).astype(np.float32)
        r, s, o = tables.build_gmm_cdf_rows(scales, means, logits)
        sym = np.round(means[:, 0] + scales[:, 0] * rng.randn(size) * 2).astype(np.int32)
        sym[::7] += 300  # a few escapes
        chunks.append((r, s, o, sym))
        rows.append(r)
        sizes.append(s)
        offsets.append(o)
        symbols.append(sym)
        n += size
    flat = (tables.stack_rows(rows), np.concatenate(sizes), np.concatenate(offsets))
    symbols = np.concatenate(symbols)
    idx = np.arange(n, dtype=np.int32)
    data = rans.encode_with_indexes(symbols, idx, *flat)
    assert data == j_rans.encode_with_indexes(symbols, idx, *flat)
    with rans.StreamingDecoder(data) as dec:
        got = [dec.decode(np.arange(s.size, dtype=np.int32), r, s, o) for r, s, o, _ in chunks]
    np.testing.assert_array_equal(np.concatenate(got), symbols)
    np.testing.assert_array_equal(rans.decode_with_indexes(data, idx, *flat), symbols)


def test_coder_rejects_what_the_library_cannot_take():
    symbols, indexes, cdfs, sizes, offsets = _case("one_row")
    with pytest.raises(TypeError, match="symbols"):
        rans.encode_with_indexes(symbols.astype(np.int64), indexes, cdfs, sizes, offsets)
    with pytest.raises(TypeError, match="cdfs"):
        rans.encode_with_indexes(symbols, indexes, cdfs.astype(np.int32), sizes, offsets)
    with pytest.raises(ValueError, match="indexes"):
        rans.encode_with_indexes(symbols, indexes + 1, cdfs, sizes, offsets)
    with pytest.raises(ValueError, match="C-contiguous"):
        rans.encode_with_indexes(symbols[::2], indexes[::2].copy(), cdfs, sizes, offsets)
    with pytest.raises(ValueError, match="sizes"):
        rans.decode_with_indexes(b"", indexes, cdfs, sizes + cdfs.shape[1], offsets)
    dec = rans.StreamingDecoder(b"\x00" * 8)
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.decode(indexes[:1], cdfs, sizes, offsets)


@pytest.mark.parametrize("pmf, tail", [
    ([0.5, 0.3, 0.15], 0.05),
    ([0.999999, 1e-9, 1e-9, 1e-12], 0.0),  # the largest entry gives up counts
    ([0.0, 0.0], 0.0),  # no mass: uniform
    (list(np.random.RandomState(2).dirichlet(np.ones(300) * 0.1)), 1e-6),
])
def test_pmf_to_quantized_cdf_equals_jax(pmf, tail):
    ours = tables.pmf_to_quantized_cdf(np.array(pmf), tail)
    np.testing.assert_array_equal(ours, j_tables.pmf_to_quantized_cdf(np.array(pmf), tail))
    assert ours[0] == 0 and ours[-1] == 1 << 16 and (np.diff(ours.astype(np.int64)) >= 1).all()


def test_pmf_to_quantized_cdf_batch_equals_jax():
    rng = np.random.RandomState(3)
    pmfs = rng.dirichlet(np.ones(40) * 0.05, size=200) * rng.uniform(0.5, 1.0, (200, 1))
    pmfs[:3] = 0.0
    tails = np.maximum(1.0 - pmfs.sum(1), 0.0)
    np.testing.assert_array_equal(tables.pmf_to_quantized_cdf_batch(pmfs, tails),
                                  j_tables.pmf_to_quantized_cdf_batch(pmfs, tails))


def test_scale_table_and_gc_tables_equal_jax():
    np.testing.assert_array_equal(tables.SCALE_TABLE, np.asarray(default_scale_table()))
    ours, theirs = tables.build_gc_tables(), j_tables.build_gc_tables()
    assert set(ours) == set(theirs)
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_gc_build_indexes_equal_jax():
    rng = np.random.RandomState(4)
    table = tables.SCALE_TABLE
    scales = np.concatenate([
        np.exp(rng.uniform(np.log(0.01), np.log(500.0), 5000)),
        table, np.nextafter(table, 0), np.nextafter(table, np.inf), [0.0, -1.0],
    ]).astype(np.float32)
    ours = tables.gc_build_indexes(scales, table)
    np.testing.assert_array_equal(ours, j_tables.gc_build_indexes(scales, table))
    # floored at 0.11 in float64, just above the table's float32 0.11: row 1
    assert ours.min() == 1 and ours.max() == 63


def test_gmm_cdf_rows_equal_jax():
    rng = np.random.RandomState(5)
    scales = np.exp(rng.randn(300, 4, 3) * 1.5).astype(np.float32)  # some above 30: capped
    means = (rng.randn(300, 4, 3) * 4).astype(np.float32)
    logits = (rng.randn(300, 4, 3) * 2).astype(np.float32)
    ours = tables.build_gmm_cdf_rows(scales, means, logits)
    theirs = j_tables.build_gmm_cdf_rows(scales, means, logits)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (1200, 194)  # the 192-symbol cap, escape, end


def test_ideal_bits_equal_jax():
    for name in ("one_row", "overflow", "multi_row"):
        case = _case(name)
        assert tables.ideal_bits(*case) == j_tables.ideal_bits(*case)
    t = tables.build_gc_tables()
    rng = np.random.RandomState(6)
    symbols = _i32(np.round(rng.randn(4000) * 30))
    indexes = _i32(rng.randint(0, 64, 4000))
    args = (symbols, indexes, t["cdfs"], t["cdf_sizes"], t["offsets"])
    assert tables.ideal_bits(*args) == j_tables.ideal_bits(*args)


@pytest.mark.parametrize("source", ["demo", "seeded"])
def test_eb_tables_from_carried_weights(source):
    """The hyper q1 z model, from the demo checkpoint or the JAX-side copy of
    a seeded port model, through ``params_from_jax``."""
    if source == "demo":
        eb_params = read_msgpack(CKPT)["entropy_bottleneck"]
    else:
        eb = EntropyBottleneck(128)
        eb.reset_parameters(torch.Generator().manual_seed(7))
        with torch.no_grad():
            eb.quantiles.add_(torch.randn(eb.quantiles.shape, generator=torch.Generator().manual_seed(8)))
        eb_params = {"quantiles": eb.quantiles.detach().numpy()}
        for k in range(eb.n_layers):
            for leaf, jname in (("_matrix", "matrix"), ("_bias", "bias"), ("_factor", "factor")):
                if hasattr(eb, f"{leaf}{k}"):
                    eb_params[f"{jname}_{k}"] = getattr(eb, f"{leaf}{k}").detach().numpy()
    eb_params = {k: np.asarray(v, np.float32) for k, v in eb_params.items()}
    state = params_from_jax({"entropy_bottleneck": eb_params})
    port = EntropyBottleneck(eb_params["quantiles"].shape[0])
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)

    ours, theirs = tables.build_eb_tables(port), j_tables.build_eb_tables(eb_params)
    for key in ("cdf_sizes", "offsets", "medians"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["cdfs"].shape == theirs["cdfs"].shape
    diff = np.abs(ours["cdfs"].astype(np.int64) - theirs["cdfs"].astype(np.int64))
    print(f"{source}: {int((diff > 0).sum())} of {diff.size} CDF entries differ by one count")
    assert diff.max() <= 1


def test_rans_library_builds_under_its_hash(monkeypatch):
    path = _build.rans_library_path()
    assert path.parent == _build.PACKAGE_DIR / "_build"
    assert path.name.startswith("libicat_rans-") and len(path.stem) == len("libicat_rans-") + 16
    assert _build.build_rans() == path and path.is_file()
    assert isinstance(rans._load(), ctypes.CDLL)
    assert _build.RANS_SOURCE not in _build.SOURCES  # nvcc's build does not take it
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-g",))
    assert _build.rans_library_path() != path  # a flag change builds anew
