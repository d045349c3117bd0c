"""Hand-written Hopper kernels and their plain PyTorch versions."""

from .gdn import (
    GDNFunction,
    gdn_backward,
    gdn_backward_reference,
    gdn_forward,
    gdn_forward_reference,
    launch_counts,
    reset_launch_counts,
)

__all__ = [
    "GDNFunction",
    "gdn_backward",
    "gdn_backward_reference",
    "gdn_forward",
    "gdn_forward_reference",
    "launch_counts",
    "reset_launch_counts",
]
