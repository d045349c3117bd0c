"""zarr v2 arrays over a key-value store (``io/ocdbt.py``), as orbax
writes each leaf of a checkpoint: ``<name>/.zarray`` (JSON) and one
zstd-compressed chunk a grid cell, ``<name>/<i>.<j>...`` (``<name>/0`` for
a 0-d array).

A chunk holds ``prod(chunks)`` elements in the array's ``order`` (``C`` or
``F``), edge chunks padded to the full chunk shape.  orbax writes every
chunk (``store_array_data_equal_to_fill_value``), so a missing chunk
raises instead of reading as ``fill_value``, which would hide a broken
tree.  Compressors other than zstd, filters and dtypes numpy does not name
raise, naming what they found.
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

from . import zstd


def read_array(store, name: str) -> np.ndarray:
    """The whole array ``name`` of ``store`` (anything with ``read(key) ->
    bytes`` and ``in``), in native byte order."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, this reader reads 2")
    compressor = meta.get("compressor")
    if not isinstance(compressor, dict) or compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}, this reader reads zstd")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {meta['filters']} are not supported")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{name}: dtype {meta['dtype']!r} unknown to numpy") from e
    if dtype.kind not in "biuf":
        raise ValueError(f"{name}: dtype {meta['dtype']!r} is not a number type")
    order = meta["order"]
    if order not in ("C", "F"):
        raise ValueError(f"{name}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} for shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype.newbyteorder("="))
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    for cell in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, cell)) if cell else '0'}"
        if key not in store:
            raise ValueError(f"{name}: chunk {key} is missing (every chunk is written)")
        raw = zstd.decompress(store.read(key))
        if len(raw) != math.prod(chunks) * dtype.itemsize:
            raise ValueError(f"{name}: chunk {key} holds {len(raw)} bytes, "
                             f"{math.prod(chunks) * dtype.itemsize} expected")
        block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(cell, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    return out
