"""zstd decompression through libzstd, bound with ``ctypes``.

The JAX trainer's orbax trees are zstd throughout: their OCDBT manifests
and B-tree nodes (``io/ocdbt.py``) and their zarr chunks (``io/zarr.py``).
The port reads them with the system's ``libzstd.so.1`` alone.  There is no
fallback to a Python package (``zstandard``, tensorstore), even where one
is installed: a machine without libzstd raises here, naming it.

A frame that states its content size decompresses in one
``ZSTD_decompress``; one that does not (tensorstore writes its chunks so)
goes through the streaming API.  Every return value is checked with
``ZSTD_isError``, and a truncated frame raises.  ``decompress_prefix``
streams no more than a given size out, as libtiff's Zstandard codec fills
a TIFF strip (``io/tiff.py``).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

# ZSTD_getFrameContentSize's two sentinels
_UNKNOWN = 2**64 - 1
_ERROR = 2**64 - 2


class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` and ``ZSTD_outBuffer`` (the same layout)."""

    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The system's libzstd with its signatures declared; raises
    ``OSError`` naming libzstd where there is none."""
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd (libzstd.so.1) was not found: reading an orbax checkpoint's "
                      "zstd-compressed nodes and chunks needs it; install libzstd")
    lib = ctypes.CDLL(name)
    size_t, void_p = ctypes.c_size_t, ctypes.c_void_p
    for fn, restype, argtypes in (
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ctypes.c_char_p, size_t]),
        ("ZSTD_decompress", size_t, [void_p, size_t, ctypes.c_char_p, size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createDCtx", void_p, []),
        ("ZSTD_freeDCtx", size_t, [void_p]),
        ("ZSTD_decompressStream", size_t, [void_p, ctypes.POINTER(_Buffer),
                                           ctypes.POINTER(_Buffer)]),
        ("ZSTD_DStreamOutSize", size_t, []),
        ("ZSTD_versionString", ctypes.c_char_p, []),
    ):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def version() -> str:
    """libzstd's version string."""
    return library().ZSTD_versionString().decode()


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytearray:
    """The decompressed bytes of ``data``: one zstd frame, or (without a
    stated content size) one or more frames back to back."""
    lib = library()
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _ERROR:
        raise ValueError(f"not a zstd frame (starts with {data[:4].hex()})")
    if size == _UNKNOWN:
        return _stream(lib, data)
    out = bytearray(size)
    dst = (ctypes.c_char * size).from_buffer(out) if size else None
    n = _check(lib, lib.ZSTD_decompress(dst, size, data, len(data)), "decompress")
    if n != size:
        raise ValueError(f"zstd frame states {size} bytes and holds {n}")
    return out


def _stream(lib: ctypes.CDLL, data: bytes) -> bytearray:
    """Streaming decompression of frames that state no content size."""
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        src = ctypes.c_char_p(data)
        inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk = lib.ZSTD_DStreamOutSize()
        buf = ctypes.create_string_buffer(chunk)
        out = bytearray()
        while True:
            outb = _Buffer(ctypes.cast(buf, ctypes.c_void_p), chunk, 0)
            left = _check(lib, lib.ZSTD_decompressStream(ctx, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "stream")
            out += ctypes.string_at(buf, outb.pos)
            # more output may wait while the buffer came back full
            if inb.pos == inb.size and outb.pos < chunk:
                break
        if left != 0:
            raise ValueError(f"truncated zstd frame: {len(data)} bytes end inside a frame")
        return out
    finally:
        lib.ZSTD_freeDCtx(ctx)


def decompress_prefix(data: bytes, size: int) -> bytes:
    """Up to the first ``size`` decompressed bytes of ``data``, streamed
    into a buffer of that size: decompression stops where the buffer is
    full or the input ends, whatever size the frame states (libtiff's
    ``ZSTDDecode``).  Raises ``ValueError`` on a zstd error."""
    lib = library()
    ctx = lib.ZSTD_createDCtx()
    if not ctx:
        raise MemoryError("ZSTD_createDCtx failed")
    try:
        data = bytes(data)
        src = ctypes.c_char_p(data)
        inb = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        buf = ctypes.create_string_buffer(max(size, 1))
        outb = _Buffer(ctypes.cast(buf, ctypes.c_void_p), size, 0)
        while True:
            left = _check(lib, lib.ZSTD_decompressStream(ctx, ctypes.byref(outb),
                                                         ctypes.byref(inb)), "stream")
            if left == 0 or inb.pos == inb.size or outb.pos == size:
                break
        return ctypes.string_at(buf, outb.pos)
    finally:
        lib.ZSTD_freeDCtx(ctx)
