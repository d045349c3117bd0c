"""Introspection and plotting helpers (port of
``imagecompression_adversarial_tpu/utils/``)."""

from .introspect import channel_maxima, layer_activations, layer_compare, show_max_bar
from .plotting import plot_or_skip, pyplot

__all__ = ["layer_activations", "layer_compare", "channel_maxima", "show_max_bar", "pyplot",
           "plot_or_skip"]
