"""Fused GDN/IGDN forward and backward: the CUDA kernels' wrappers and
their plain versions.

Replaces the repository's one Pallas kernel, ``_gdn_kernel`` launched by
``_gdn_forward`` (``scripts/pallas_gdn.py:100``), and its closed-form
backward ``_gdn_fused_bwd`` (``:125-147``, plain XLA in the reference), with
the hand-written ``sm_90a`` kernels in ``csrc/gdn.cu``.  On a ``(rows, C)``
view of channels_last activations::

    norm[n, o] = sum_i gamma[o, i] * x[n, i]^2 + beta[o]
    out = x * rsqrt(norm)   (GDN)      out = x * sqrt(norm)   (IGDN)

Bound on an H100 SXM: for the largest call of a hyper training step
(8 x 256x256 crops, rows 131,072, C=128) the x read plus the out write is
2 x 67.1 MB, 40 us at 3.35 TB/s; the channel sum is 4.3 GFLOP, 64 us at the
67 TFLOP/s fp32 peak.  So the kernel is bounded by operations.  It takes
the sum as an fp32 FMA chain in the order of an fp32 matrix product (bit for
bit cuBLAS's on an H100, ``kernels/gdn_accuracy.py``), and reads x once
from device memory and writes out once, keeping x^2 and the norm on chip.

The backward kernel recomputes the norm with the same chain and, for an
output gradient g, writes ``dx = g s + 2 x (dnorm @ gamma)`` and/or
``dnorm`` (``s`` = rsqrt(norm) or sqrt(norm); dnorm = -0.5 g x s^3 or
0.5 g x / s) in one pass: it reads x and g and writes dx, where the plain
chain takes 14 launches and up to four (rows, C) temporaries.
``dgamma = dnorm^T @ x^2`` and ``dbeta = sum_n dnorm`` stay on cuBLAS and
torch, as in the plain backward.

``gdn_forward`` and ``gdn_backward`` send a CUDA tensor to the kernel and a
CPU tensor to ``gdn_forward_reference`` / ``gdn_backward_reference``; they
raise on any other device, dtype, layout or width.  ``GDNFunction`` wraps
them in autograd; with ``use_kernel=False`` it runs both plain versions on
any device.
"""

from __future__ import annotations

import collections

import torch
from torch.autograd.function import once_differentiable

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


def gdn_backward_reference(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
    inverse: bool, need_dx: bool, need_dnorm: bool,
):
    """Plain PyTorch version of the backward kernel: ``(dx, dnorm)`` for
    the output gradient ``g``, each ``None`` where not asked for.

    ``s`` = sqrt(norm) (IGDN) or rsqrt(norm) (GDN); ``dnorm`` = 0.5 g x / s
    or -0.5 g x s^3; dx = g s + 2 x (dnorm @ gamma).  The products run in
    place, in the order of those formulas (bit for bit the out-of-place
    results, but where 2 x (dnorm @ gamma) is subnormal), so that at most
    four (rows, C) temporaries live at once (a 4096x3072 image's first GDN
    is 1.6 GB a tensor)."""
    x_sq = x * x
    s = x_sq @ gamma.t()
    s += beta
    del x_sq
    s = s.sqrt_() if inverse else s.rsqrt_()
    dnorm = g * (0.5 if inverse else -0.5)
    dnorm *= x
    if inverse:
        dnorm /= s
    else:
        s3 = s * s
        s3 *= s
        dnorm *= s3
        del s3
    dx = None
    if need_dx:
        m = dnorm @ gamma
        m *= x
        m *= 2.0
        dx = g * s
        dx += m
        del m
    return dx, dnorm if need_dnorm else None


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           name: str = "gdn_forward", g=None) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} takes x of shape (rows, C), got {tuple(x.shape)}")
    c = x.shape[1]
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} rows, got {x.shape[0]}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{name} supports 1 <= C <= {MAX_CHANNELS}, got C={c}")
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"gamma {tuple(gamma.shape)} / beta {tuple(beta.shape)} do not match C={c}"
        )
    if g is not None and g.shape != x.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} differs from x {tuple(x.shape)}")
    named = (("x", x), ("gamma", gamma), ("beta", beta)) + ((("g", g),) if g is not None else ())
    for what, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors; {what} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors; {what} is not")
        if t.device != x.device:
            raise ValueError(f"{what} is on {t.device}, x on {x.device}")


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
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    from ._build import load_library

    lib = load_library()
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


def gdn_backward(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, g: torch.Tensor,
    inverse: bool, need_dx: bool, need_dnorm: bool,
):
    """``(dx, dnorm)`` of the fused GDN (``inverse=False``) or IGDN on ``x``
    (rows, C) for the output gradient ``g``, each ``None`` where not asked
    for (at least one must be).

    A CUDA tensor launches the backward kernel once; a CPU tensor runs the
    plain version.
    """
    _check(x, gamma, beta, "gdn_backward", g)
    if not (need_dx or need_dnorm):
        raise ValueError("gdn_backward: neither dx nor dnorm asked for")
    if x.device.type == "cpu":
        return gdn_backward_reference(x, gamma, beta, g, inverse, need_dx, need_dnorm)
    if x.device.type != "cuda":
        raise ValueError(f"gdn_backward runs on cuda or cpu, not {x.device}")
    dx = torch.empty_like(x) if need_dx else None
    dnorm = torch.empty_like(x) if need_dnorm else None
    if x.shape[0] == 0:
        return dx, dnorm
    from ._build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.icat_gdn_bwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
            dx.data_ptr() if need_dx else None, dnorm.data_ptr() if need_dnorm else None,
            x.shape[0], x.shape[1], int(inverse), stream,
        )
    if rc != 0:
        raise RuntimeError(f"icat_gdn_bwd failed with CUDA error {rc}")
    launch_counts["gdn_bwd"] += 1
    return dx, dnorm


def param_grads(x: torch.Tensor, dnorm: torch.Tensor, need_dgamma: bool, need_dbeta: bool):
    """``(dgamma, dbeta)`` from ``dnorm``: dnorm^T @ x^2 (cuBLAS) and the
    sum of dnorm over rows, each ``None`` where not asked for."""
    dgamma = dnorm.t() @ (x * x) if need_dgamma else None
    dbeta = dnorm.sum(0) if need_dbeta else None
    return dgamma, dbeta


def kernel_layout(rows: int, c: int, inverse: bool, backward: bool = False) -> dict:
    """The launch the forward (or the backward) kernel makes for ``(rows,
    C)`` on the current CUDA device: rows per tile, resident blocks an SM,
    blocks launched and bytes of shared memory a block; for the backward
    also warps a block and a group, stages of x and g tiles a group, and the
    rows and channels a lane holds (a group's tile is ``tile`` rows)."""
    import ctypes

    from ._build import load_library

    keys = ("tile", "blocks_per_sm", "grid", "smem_bytes")
    if backward:
        keys += ("warps", "group_warps", "stages", "lane_rows", "lane_channels")
    out = (ctypes.c_int * len(keys))()
    lib = load_library()
    entry = lib.icat_gdn_bwd_layout if backward else lib.icat_gdn_layout
    rc = entry(rows, c, int(inverse), out)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} failed with CUDA error {rc}")
    return dict(zip(keys, out))


class GDNFunction(torch.autograd.Function):
    """Autograd around the fused forward and backward kernels.

    ``use_kernel=False`` runs both plain versions on any device; it exists
    so that a run on the card can be compared with the kernels'.  The
    backward is not itself differentiable (``once_differentiable``): a
    second derivative through GDN raises.
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse: bool, use_kernel: bool = True):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        ctx.use_kernel = use_kernel
        fwd = gdn_forward if use_kernel else gdn_forward_reference
        return fwd(x, gamma, beta, inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        """One backward kernel launch (or the plain chain) for dx and, where
        gamma or beta needs a gradient, dnorm; then dgamma and dbeta from
        dnorm (``param_grads``)."""
        x, gamma, beta = ctx.saved_tensors
        need_dx, need_dgamma, need_dbeta = ctx.needs_input_grad[:3]
        need_dnorm = need_dgamma or need_dbeta
        if ctx.use_kernel:
            dx, dnorm = gdn_backward(x, gamma, beta, g.contiguous(), ctx.inverse, need_dx,
                                     need_dnorm)
        else:
            dx, dnorm = gdn_backward_reference(x, gamma, beta, g, ctx.inverse, need_dx,
                                               need_dnorm)
        dgamma, dbeta = param_grads(x, dnorm, need_dgamma, need_dbeta)
        return dx, dgamma, dbeta, None, None
