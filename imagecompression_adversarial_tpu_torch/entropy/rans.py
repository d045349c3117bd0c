"""ctypes binding of the rANS coder (port of
``imagecompression_adversarial_tpu/entropy/rans.py``).

The coder is host C++ (``csrc/rans.cc``, the same C ABI and bytes as the
JAX package's), compiled with g++ on first use by ``kernels/_build.py``.
The call shape is CompressAI's ``encode_with_indexes``: flat symbol and
index arrays against a stack of per-row quantized CDFs.

Every array is passed as it is: symbols, indexes, sizes and offsets must be
contiguous ``int32`` numpy arrays and the CDF rows a contiguous 2-D
``uint32`` array; anything else raises, as do indexes outside the rows or a
row size beyond the stride.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..kernels._build import build_rans

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
# the table arguments of every coding call: cdfs, cdf_stride, cdf_sizes, offsets
_TABLE_ARGS = [_U32P, ctypes.c_int, _I32P, _I32P]


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_rans()))
    lib.rans_encode_with_indexes.restype = ctypes.c_int
    lib.rans_encode_with_indexes.argtypes = [
        _I32P, _I32P, ctypes.c_int, *_TABLE_ARGS, _U8P, ctypes.c_int,
    ]
    lib.rans_decode_with_indexes.restype = ctypes.c_int
    lib.rans_decode_with_indexes.argtypes = [
        _U8P, ctypes.c_int, _I32P, ctypes.c_int, *_TABLE_ARGS, _I32P,
    ]
    lib.rans_dec_create.restype = ctypes.c_void_p
    lib.rans_dec_create.argtypes = [_U8P, ctypes.c_int]
    lib.rans_dec_decode.restype = ctypes.c_int
    lib.rans_dec_decode.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int, *_TABLE_ARGS, _I32P,
    ]
    lib.rans_dec_free.restype = None
    lib.rans_dec_free.argtypes = [ctypes.c_void_p]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check(name: str, arr, dtype, ndim: int) -> None:
    if not isinstance(arr, np.ndarray) or arr.dtype != dtype or arr.ndim != ndim:
        raise TypeError(f"{name} must be a {ndim}-D {np.dtype(dtype).name} numpy array")
    if not arr.flags.c_contiguous:
        raise ValueError(f"{name} must be C-contiguous")


def _check_tables(indexes, cdfs, cdf_sizes, offsets) -> None:
    _check("indexes", indexes, np.int32, 1)
    _check("cdfs", cdfs, np.uint32, 2)
    _check("cdf_sizes", cdf_sizes, np.int32, 1)
    _check("offsets", offsets, np.int32, 1)
    rows = cdfs.shape[0]
    if cdf_sizes.size != rows or offsets.size != rows:
        raise ValueError(f"{rows} CDF rows but {cdf_sizes.size} sizes and {offsets.size} offsets")
    if rows and (cdf_sizes.min() < 1 or cdf_sizes.max() >= cdfs.shape[1]):
        raise ValueError(f"CDF sizes must lie in [1, {cdfs.shape[1] - 1}] (the stride less 1)")
    if indexes.size and (indexes.min() < 0 or indexes.max() >= rows):
        raise ValueError(f"indexes must lie in [0, {rows})")


def encode_with_indexes(symbols: np.ndarray, indexes: np.ndarray, cdfs: np.ndarray,
                        cdf_sizes: np.ndarray, offsets: np.ndarray) -> bytes:
    """Encode ``symbols`` (N,) with the CDF row ``indexes[i]`` each.

    ``cdfs`` (R, stride): row r holds ``cdf_sizes[r] + 1`` valid entries,
    from 0 to 2^16; symbol ``cdf_sizes[r] - 1`` is the escape, and a value
    outside the alphabet is coded as the escape plus 4-bit bypass chunks.
    ``offsets[r]`` is the symbol value of the row's first slot.
    """
    _check("symbols", symbols, np.int32, 1)
    _check_tables(indexes, cdfs, cdf_sizes, offsets)
    if symbols.size != indexes.size:
        raise ValueError(f"{symbols.size} symbols but {indexes.size} indexes")
    capacity = max(1024, symbols.size * 8)
    out = np.empty(capacity, np.uint8)
    written = _load().rans_encode_with_indexes(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32), symbols.size,
        _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1],
        _ptr(cdf_sizes, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
        _ptr(out, ctypes.c_uint8), capacity,
    )
    if written < 0:
        raise RuntimeError("rans encode buffer overflow")
    return bytes(out[:written])


def decode_with_indexes(data: bytes, indexes: np.ndarray, cdfs: np.ndarray,
                        cdf_sizes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Decode ``data`` back to (N,) int32 symbols, N = ``indexes.size``."""
    _check_tables(indexes, cdfs, cdf_sizes, offsets)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(indexes.size, np.int32)
    rc = _load().rans_decode_with_indexes(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(indexes, ctypes.c_int32), indexes.size,
        _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1],
        _ptr(cdf_sizes, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
        _ptr(out, ctypes.c_int32),
    )
    if rc != 0:
        raise RuntimeError("rans decode failed")
    return out


class StreamingDecoder:
    """Incremental decoder for the autoregressive models: the CDF rows of a
    symbol are known only once the symbols before it are decoded, so the
    caller decodes one chunk (a wavefront) at a time, each chunk with its
    own tables.  ``close`` (or the ``with`` block) frees the native state."""

    def __init__(self, data: bytes):
        self._lib = _load()
        buf = np.frombuffer(data, np.uint8)
        self._handle = self._lib.rans_dec_create(_ptr(buf, ctypes.c_uint8), buf.size)

    def decode(self, indexes: np.ndarray, cdfs: np.ndarray, cdf_sizes: np.ndarray,
               offsets: np.ndarray) -> np.ndarray:
        """Decode the next ``indexes.size`` symbols with these tables."""
        if not self._handle:
            raise RuntimeError("StreamingDecoder is closed")
        _check_tables(indexes, cdfs, cdf_sizes, offsets)
        out = np.empty(indexes.size, np.int32)
        rc = self._lib.rans_dec_decode(
            self._handle, _ptr(indexes, ctypes.c_int32), indexes.size,
            _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1],
            _ptr(cdf_sizes, ctypes.c_int32), _ptr(offsets, ctypes.c_int32),
            _ptr(out, ctypes.c_int32),
        )
        if rc != 0:
            raise RuntimeError("rans streaming decode failed")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.rans_dec_free(self._handle)
            self._handle = None

    def __enter__(self) -> "StreamingDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
