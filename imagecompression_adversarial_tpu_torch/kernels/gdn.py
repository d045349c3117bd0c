"""Fused GDN/IGDN forward: the CUDA kernel's wrapper and its plain version.

Replaces the repository's one Pallas kernel, ``_gdn_kernel`` launched by
``_gdn_forward`` (``scripts/pallas_gdn.py:100``), with the hand-written
``sm_90a`` kernel in ``csrc/gdn.cu``.  On a ``(rows, C)`` view of
channels_last activations::

    norm[n, o] = sum_i gamma[o, i] * x[n, i]^2 + beta[o]
    out = x * rsqrt(norm)   (GDN)      out = x * sqrt(norm)   (IGDN)

Bound on an H100 SXM: for the largest call of a hyper training step
(8 x 256x256 crops, rows 131,072, C=128) the x read plus the out write is
2 x 67.1 MB, 40 us at 3.35 TB/s; the channel sum is 4.3 GFLOP, 64 us at the
67 TFLOP/s fp32 peak.  So the kernel is bounded by operations.  It takes
the sum as an fp32 FMA chain in the order of an fp32 matrix product (bit for
bit cuBLAS's on an H100, ``kernels/gdn_accuracy.py``), and reads x once
from device memory and writes out once, keeping x^2 and the norm on chip.

``gdn_forward`` sends a CUDA tensor to the kernel and a CPU tensor to
``gdn_forward_reference``; it raises on any other device, dtype, layout or
width.  ``GDNFunction`` wraps either in autograd with the closed-form
backward of ``_gdn_fused_bwd`` (``scripts/pallas_gdn.py:125-147``), which
the reference also leaves to plain array code.
"""

from __future__ import annotations

import collections

import torch

#: Largest channel count the kernel takes (gamma must fit in shared memory).
MAX_CHANNELS = 192
#: Largest row count: the kernel takes rows as a C ``int`` (its offsets are
#: ``size_t``); an 8192x6144 image's first GDN has 12,582,912.
MAX_ROWS = 2 ** 31 - 1

#: Kernel launches by name, counted by the wrappers where they launch.
launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def gdn_forward_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on ``x`` of shape (rows, C)."""
    norm = (x * x) @ gamma.t() + beta
    return x * torch.sqrt(norm) if inverse else x * torch.rsqrt(norm)


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"gdn_forward takes x of shape (rows, C), got {tuple(x.shape)}")
    c = x.shape[1]
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"gdn_forward takes at most {MAX_ROWS} rows, got {x.shape[0]}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"gdn_forward supports 1 <= C <= {MAX_CHANNELS}, got C={c}")
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} do not match C={c}"
        )
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"gdn_forward takes float32 tensors; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gdn_forward takes contiguous tensors; {name} is not")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gdn_forward(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """Fused GDN (``inverse=False``) or IGDN forward on ``x`` (rows, C).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return gdn_forward_reference(x, gamma, beta, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"gdn_forward runs on cuda or cpu, not {x.device}")
    from ._build import load_library

    lib = load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.icat_gdn_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], int(inverse), stream,
        )
    if rc != 0:
        raise RuntimeError(f"icat_gdn_fwd failed with CUDA error {rc}")
    launch_counts["gdn_fwd"] += 1
    return out


def kernel_layout(rows: int, c: int, inverse: bool) -> dict:
    """The launch the kernel makes for ``(rows, C)`` on the current CUDA
    device: rows per tile, resident blocks an SM, blocks launched and bytes
    of shared memory a block."""
    import ctypes

    from ._build import load_library

    out = (ctypes.c_int * 4)()
    rc = load_library().icat_gdn_layout(rows, c, int(inverse), out)
    if rc != 0:
        raise RuntimeError(f"icat_gdn_layout failed with CUDA error {rc}")
    return dict(zip(("tile", "blocks_per_sm", "grid", "smem_bytes"), out))


class GDNFunction(torch.autograd.Function):
    """Autograd around the fused forward, with the closed-form backward.

    ``use_kernel=False`` runs the plain version on any device; it exists so
    that a run on the card can be compared with the kernel's.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse: bool, use_kernel: bool = True):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        fwd = gdn_forward if use_kernel else gdn_forward_reference
        return fwd(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        """``s`` = sqrt(norm) (IGDN) or rsqrt(norm) (GDN); ``dnorm`` =
        0.5 g x / s or -0.5 g x s^3; dx = g s + 2 x (dnorm @ gamma).  The
        products run in place, in the order of those formulas (bit for bit
        the out-of-place results, but where 2 x (dnorm @ gamma) is
        subnormal), so that at most four (rows,
        C) temporaries live at once beside ``x_sq``, which only dgamma
        keeps (a 4096x3072 image's first GDN is 1.6 GB a tensor)."""
        x, gamma, beta = ctx.saved_tensors
        x_sq = x * x
        s = x_sq @ gamma.t()
        s += beta
        if not ctx.needs_input_grad[1]:
            del x_sq
        s = s.sqrt_() if ctx.inverse else s.rsqrt_()
        dnorm = g * (0.5 if ctx.inverse else -0.5)
        dnorm *= x
        if ctx.inverse:
            dnorm /= s
        else:
            s3 = s * s
            s3 *= s
            dnorm *= s3
            del s3
        dx = None
        if ctx.needs_input_grad[0]:
            m = dnorm @ gamma
            m *= x
            m *= 2.0
            dx = g * s
            dx += m
            del m
        del s
        dgamma = dnorm.t() @ x_sq if ctx.needs_input_grad[1] else None
        dbeta = dnorm.sum(0) if ctx.needs_input_grad[2] else None
        return dx, dgamma, dbeta, None, None
