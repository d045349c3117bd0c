"""Compare what the port's real coder and the JAX package's hand the rANS
coder, in coding order (used by ``test_torch_autoregressive.py`` and
``test_torch_realcodec.py``).

The two sides run float32 transforms whose sums run in another order, so a
symbol may round the other way where its value sits within ``ROUND_ATOL``
of a half-integer, and an index may pick the neighbouring row where its
scale sits within ``SCALE_RTOL`` (relative) of a scale-table boundary.
Every difference up to the first symbol that differs must be one of these;
after it, the autoregressive families' later parameters follow from another
canvas, so what differs there is only counted.
"""

import numpy as np

ROUND_ATOL = 1e-4
SCALE_RTOL = 1e-5
SCALE_BOUND = 0.11


def near_scale_boundary(scale: float, table: np.ndarray) -> bool:
    s = max(float(scale), SCALE_BOUND)
    bounds = table[:-1].astype(np.float64)
    return bool(np.min(np.abs(s - bounds) / bounds) <= SCALE_RTOL)


def near_rounding_boundary(value: float) -> bool:
    return abs(float(value) - np.floor(value) - 0.5) <= ROUND_ATOL


def compare_streams(streams, table) -> dict:
    """``streams``: (name, ours, theirs) in coding order; ``ours`` holds the
    port's ``symbols``, ``indexes``, ``values`` (before rounding) and, where
    there is a scale table, ``scales``; ``theirs`` the JAX side's
    ``symbols`` and ``indexes``.  Asserts the rule above and returns the
    counts."""
    counts = {"symbols": 0, "indexes": 0, "total": 0, "first": None}
    diverged = False
    for name, ours, theirs in streams:
        assert ours["symbols"].shape == theirs["symbols"].shape, name
        sym_diff = ours["symbols"] != theirs["symbols"]
        idx_diff = ours["indexes"] != theirs["indexes"]
        counts["symbols"] += int(sym_diff.sum())
        counts["indexes"] += int(idx_diff.sum())
        counts["total"] += sym_diff.size
        for k in np.nonzero(sym_diff | idx_diff)[0]:
            if diverged:
                break
            if counts["first"] is None:
                counts["first"] = f"{name}[{k}]"
            if idx_diff[k]:
                scale = ours["scales"][k]
                assert near_scale_boundary(scale, table), (
                    f"{name}[{k}]: index {ours['indexes'][k]} vs {theirs['indexes'][k]} at scale "
                    f"{scale!r}, not within {SCALE_RTOL} of a table boundary")
            if sym_diff[k]:
                value = ours["values"][k]
                assert near_rounding_boundary(value), (
                    f"{name}[{k}]: symbol {ours['symbols'][k]} vs {theirs['symbols'][k]} at "
                    f"value {value!r}, not within {ROUND_ATOL} of a rounding boundary")
                diverged = True
    return counts


def table_differences(ours: dict, theirs: dict) -> dict:
    """How two coded tables differ: for ``cdfs``, ``cdf_sizes`` and
    ``offsets`` the number of entries that differ (every entry when the
    shapes differ) and the largest difference (None then)."""
    out = {}
    for key in ("cdfs", "cdf_sizes", "offsets"):
        a, b = ours[key].astype(np.int64), theirs[key].astype(np.int64)
        if a.shape != b.shape:
            out[key] = (max(a.size, b.size), None)
        else:
            d = np.abs(a - b)
            out[key] = (int((d > 0).sum()), int(d.max()) if d.size else 0)
    return out
