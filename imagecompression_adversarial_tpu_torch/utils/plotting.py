"""matplotlib, imported only where a plot is drawn: the numbers of every
analysis run where matplotlib is not installed, and the CLIs say which plot
they did not write."""

from __future__ import annotations

from typing import Callable


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; raises
    ``ModuleNotFoundError`` where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_or_skip(plot: Callable, path: str, *args, **kwargs) -> bool:
    """``plot(*args, **kwargs)``, which writes ``path``; where matplotlib is
    not installed, print one line saying the plot was not written and
    return False.  Any other error propagates."""
    try:
        plot(*args, **kwargs)
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"plot not written: {path} (matplotlib is not installed)", flush=True)
        return False
    return True
