"""Where this rank's part of a sharded tensor sits, and the collectives that
make the codec's layers and reductions exact over the parts.

The parallel layer (``parallel/``) runs one process per rank.  Under
``sharded(rows=axis)`` every NCHW activation on the rank holds one
contiguous block of the image's rows (``row_blocks``: equal blocks where
the rows divide by the ranks x ROW_MULTIPLE; otherwise every rank but the
last a multiple of ROW_MULTIPLE, the last the rest, which may be none, so
that every interior block boundary still lies on a multiple of
ROW_MULTIPLE):

* ``Conv`` (and ``MaskedConv``) fetch the rows their kernel reaches across
  the block's edges from the neighbouring ranks (``conv2d_rows``); zero
  rows stand in only at the image's global top and bottom, as the
  convolution's padding does; a rank whose block is empty joins the
  exchange and yields an empty block;
* reductions over the rows become global (``mean``, ``row_sum``);
* a cyclic roll of the rows (tic's shifted windows) exchanges the rows
  that wrap between neighbouring blocks (``roll_rows``), and a layer
  whose every output reads every row (nlaic's keys and values) gathers
  them (``shared_rows``); ``row_offset`` places a block in the image;
* a step that needs the whole image at once (a resize, the
  self-ensemble's rotations, ``-p``'s reflect padding) gathers it
  (``shared_rows``, or ``gather_rows`` outside autograd), works on the
  whole image on every rank and keeps this rank's rows of the result
  (``own_rows``, which splits by ``row_blocks``: the padded height of
  ``-p`` and the rotated variants' ``W`` need not divide by the ranks x
  ROW_MULTIPLE); the gathers take blocks of any heights (each padded to the
  tallest, gathered and trimmed), which a gather of the heights gives
  unless the run's caller declared its row blocks even (``sharded(...,
  even_rows=True)``: every height is this rank's);
* the training forward's noise is drawn for the global tensor and this
  rank keeps its block (``local_draw``), so that a sharded run draws what
  the one-process run on the whole tensor draws;
* a parameter's gated lower bound (GDN's ``beta`` and ``gamma``) gates the
  global gradient (``param_lower_bound``).

``sharded(batch=axis)`` alone slices the noise draws by batch and gates
the parameters' bounds on the global gradient.

The collectives are ``all_reduce`` (sums) and ``all_gather_into_tensor``
(the halo exchange, the rolls, the row and result gathers, the MS-SSIM
loss's whole image: ``all_rows``), which NCCL and gloo both
run on CUDA tensors.  The sums keep the loss replicated: their backward
passes the gradient through unchanged, so each rank's gradients are its
part of the global loss's, and the halo exchange's backward sends each
halo row's gradient back to the rank that owns the row.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .bounds import lower_bound

#: A row shard's block starts on a multiple of this many image rows, so that
#: it starts on an even row at each of a codec's six stride-2 stages.
ROW_MULTIPLE = 64


def row_blocks(total: int, n: int) -> List[int]:
    """The rows each of ``n`` row shards holds of ``total``: every shard but
    the last ``ceil(total / (n x ROW_MULTIPLE)) x ROW_MULTIPLE``, the last
    the rest (0 where none is left).  Equal blocks where ``total`` divides
    by ``n x ROW_MULTIPLE``; 128 rows on 4 shards are 64, 64, 0 and 0."""
    block = -(-total // (n * ROW_MULTIPLE)) * ROW_MULTIPLE
    return [max(0, min(block, total - i * block)) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group, this rank's
    index along it and its size."""

    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Shard:
    """``batch``: the axis the global batch is split over (blocks of equal
    size, in rank order); ``rows``: the axis the rows are split over;
    ``even_rows``: every row-split tensor of the run holds blocks of one
    height on every rank, so that ``block_heights`` needs no gather."""

    batch: Optional[Axis] = None
    rows: Optional[Axis] = None
    even_rows: bool = False


_CURRENT: contextvars.ContextVar[Optional[Shard]] = contextvars.ContextVar(
    "icat_shard", default=None)


def row_axis() -> Optional[Axis]:
    """The row axis of the active shard, or None."""
    s = _CURRENT.get()
    return None if s is None else s.rows


@contextlib.contextmanager
def sharded(batch: Optional[Axis] = None, rows: Optional[Axis] = None,
            even_rows: bool = False) -> Iterator[Shard]:
    """Run the enclosed code as this rank's part of a sharded run.  Pass
    ``even_rows`` where the caller knows that every row total the run
    splits (the input's, and any that ``own_rows`` splits) divides by the
    ranks x ROW_MULTIPLE: the blocks' heights are then this rank's on every
    rank, with no gather."""
    with within(Shard(batch, rows, even_rows)) as s:
        yield s


def current() -> Optional[Shard]:
    """The active shard, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def within(s: Optional[Shard]) -> Iterator[Optional[Shard]]:
    """Run the enclosed code under ``s`` (a ``current()`` taken earlier).
    A checkpoint's recompute runs in the backward, on the autograd
    engine's thread for CUDA tensors, where the caller's shard is not set:
    the recomputed code enters the shard its forward saw."""
    token = _CURRENT.set(s)
    try:
        yield s
    finally:
        _CURRENT.reset(token)


def all_reduce_(buf: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``buf`` over ``axis`` in place (not differentiable)."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf


# ``all_gather_into_tensor`` is named ``all_gather_single`` in newer torch
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(slot: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``slot`` (of one shape on every rank) of ``group``'s
    ``size`` ranks along a new leading axis, in rank order (not
    differentiable)."""
    slot = slot.contiguous()
    out = slot.new_empty((size * slot.shape[0], *slot.shape[1:]) if slot.dim() else (size,))
    _all_gather_flat(out, slot, group=group)
    return out.view(size, *slot.shape)


def gather(slot: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``all_gather`` over ``axis``."""
    return all_gather(slot, axis.group, axis.size)


def block_heights(h: int, axis: Axis, like: torch.Tensor) -> List[int]:
    """The row count of every rank's block along ``axis``, from each rank's
    own ``h``: ``h`` on every rank under an ``even_rows`` shard, else one
    gather of a tensor of ``like``'s dtype and device."""
    s = _CURRENT.get()
    if s is not None and s.even_rows:
        return [h] * axis.size
    return [int(v) for v in gather(like.new_full((1,), h), axis).flatten().tolist()]


def gather_blocks(t: torch.Tensor, axis: Axis) -> Tuple[torch.Tensor, List[int]]:
    """The whole NCHW tensor from every rank's block of rows, the blocks of
    any heights (each padded to the tallest, gathered, trimmed), and the
    heights (not differentiable)."""
    heights = block_heights(t.shape[2], axis, t)
    tallest = max(heights)
    if t.shape[2] < tallest:
        t = F.pad(t, (0, 0, 0, tallest - t.shape[2]))
    slots = gather(t.contiguous(), axis)
    if min(heights) == tallest:
        return torch.cat(slots.unbind(0), dim=2), heights
    return torch.cat([slots[i, :, :, :hh] for i, hh in enumerate(heights)], dim=2), heights


class _AllSum(torch.autograd.Function):
    """The sum over an axis of a tensor each rank holds a part of; the
    backward is the identity, since the sum is the replicated value every
    rank goes on with."""

    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce_(t.detach().clone().contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``t`` summed over every rank of ``axis`` (differentiable)."""
    return _AllSum.apply(t, axis)


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the row shards (``t`` itself when unsharded)."""
    rows = row_axis()
    return t if rows is None else all_sum(t, rows)


def row_count() -> int:
    """How many row shards there are (1 when unsharded)."""
    rows = row_axis()
    return 1 if rows is None else rows.size


def mean(t: torch.Tensor, dim: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``torch.mean(t, dim)`` of an NCHW tensor, over the whole image when
    its rows are sharded (``dim`` must then reduce the rows, dim 2)."""
    rows = row_axis()
    if rows is None:
        return torch.mean(t) if dim is None else torch.mean(t, dim=tuple(dim))
    dims = tuple(range(t.dim())) if dim is None else tuple(d % t.dim() for d in dim)
    if 2 not in dims:
        raise ValueError(f"a mean over dims {dims} keeps the sharded rows; reduce dim 2 too")
    count = 1
    for d in dims:
        count *= t.shape[d]
    total = t.sum() if dim is None else t.sum(dim=dims)
    return all_sum(total, rows) / (count * rows.size)


@torch.no_grad()
def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The whole NCHW tensor on every rank, from each rank's rows (not
    differentiable)."""
    return all_rows(t)


class _AllRows(torch.autograd.Function):
    """The whole NCHW tensor on every rank, from each rank's rows.  Every
    rank goes on to compute the same loss from it, so the gradient of a
    rank's rows is their slice of the whole tensor's gradient: the backward
    keeps that slice and sends nothing."""

    @staticmethod
    def forward(ctx, t, axis):
        whole, heights = gather_blocks(t, axis)
        ctx.start, ctx.h = sum(heights[:axis.index]), t.shape[2]
        return whole

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.start:ctx.start + ctx.h], None


def all_rows(t: torch.Tensor) -> torch.Tensor:
    """``gather_rows``, differentiable: the attack's MS-SSIM loss takes the
    whole image's windows, pools and means from it."""
    rows = row_axis()
    return t if rows is None else _AllRows.apply(t, rows)


class _SharedRows(torch.autograd.Function):
    """The whole NCHW tensor on every rank, from each rank's rows, where
    each rank computes its own part of the loss from it (the non-local
    block's keys and values, attended by this rank's queries): the
    gradient of a rank's rows is the sum of every rank's gradient of
    them, so the backward sums the whole tensor's gradient over the ranks
    and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, t, axis):
        whole, heights = gather_blocks(t, axis)
        ctx.axis, ctx.start, ctx.h = axis, sum(heights[:axis.index]), t.shape[2]
        return whole

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.axis)
        return g[:, :, ctx.start:ctx.start + ctx.h].contiguous(), None


def shared_rows(t: torch.Tensor) -> torch.Tensor:
    """The whole NCHW tensor from each rank's rows, for a use in which each
    rank's part of the loss reads every row (differentiable; ``t`` itself
    when unsharded)."""
    rows = row_axis()
    return t if rows is None else _SharedRows.apply(t, rows)


def own_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's block (``row_blocks``) of the rows (dim 2) of a whole
    NCHW tensor that every rank holds, the inverse of ``gather_rows``
    (differentiable: a slice; ``t`` itself when unsharded)."""
    s = _CURRENT.get()
    rows = None if s is None else s.rows
    if rows is None:
        return t
    blocks = row_blocks(t.shape[2], rows.size)
    if s.even_rows and min(blocks) != max(blocks):
        raise ValueError(f"{t.shape[2]} rows split {blocks} over the ranks, under a shard "
                         "whose row blocks were to be even")
    return t.narrow(2, sum(blocks[:rows.index]), blocks[rows.index])


def row_offset(t: torch.Tensor) -> int:
    """The global index of the first row of this rank's block ``t`` (NCHW;
    0 when unsharded).  Every rank of the row axis calls it
    (``block_heights``)."""
    rows = row_axis()
    if rows is None:
        return 0
    return sum(block_heights(t.shape[2], rows, t)[:rows.index])


class _RollRows(torch.autograd.Function):
    """``torch.roll(x, shift, dim)`` of the whole tensor along its sharded
    rows (``dim``), with wrap-around, restricted to this rank's block: for
    ``shift`` -k the block drops its first k rows and takes the first k of
    the next rank (the last rank those of the first); +k the mirror.  The
    roll permutes rows, so its backward is the roll by ``-shift``."""

    @staticmethod
    def forward(ctx, x, shift, dim, axis):
        ctx.shift, ctx.dim, ctx.axis = shift, dim, axis
        return _roll_rows(x, shift, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _roll_rows(g, -ctx.shift, ctx.dim, ctx.axis), None, None, None


def _roll_rows(x: torch.Tensor, shift: int, dim: int, axis: Axis) -> torch.Tensor:
    h, k = x.shape[dim], abs(shift)
    if k > h:
        raise ValueError(f"a roll by {shift} reaches past a shard of {h} rows")
    if k == 0:
        return x
    i, n = axis.index, axis.size
    if shift < 0:  # my first k rows go to the rank above
        slots = gather(x.narrow(dim, 0, k), axis)
        return torch.cat([x.narrow(dim, k, h - k), slots[(i + 1) % n]], dim=dim)
    slots = gather(x.narrow(dim, h - k, k), axis)  # my last k rows go to the rank below
    return torch.cat([slots[(i - 1) % n], x.narrow(dim, 0, h - k)], dim=dim)


def roll_rows(x: torch.Tensor, shift: int, dim: int = 2) -> torch.Tensor:
    """``torch.roll(x, shift, dims=dim)`` of the whole image along its rows
    (``dim``: 2 for NCHW, 1 for NHWC), on this rank's block when the rows
    are sharded (differentiable)."""
    rows = row_axis()
    if rows is None:
        return torch.roll(x, shift, dims=dim)
    return _RollRows.apply(x, shift, dim, rows)


def local_draw(y: torch.Tensor, draw: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``draw(template)`` for ``y``'s part of the global tensor: the draw
    is made for the global shape (``template`` has it, and ``y``'s dtype
    and device) and this rank keeps its batch block and its rows."""
    s = _CURRENT.get()
    if s is None or (s.batch is None and s.rows is None):
        return draw(y)
    n, c, h, w = y.shape
    nb = 1 if s.batch is None else s.batch.size
    b0 = 0 if s.batch is None else s.batch.index * n
    heights = [h] if s.rows is None else block_heights(h, s.rows, y)
    r0 = 0 if s.rows is None else sum(heights[:s.rows.index])
    full = draw(y.new_empty(()).expand(n * nb, c, sum(heights), w))
    return full[b0:b0 + n, :, r0:r0 + h]


class _Halo(torch.autograd.Function):
    """Pad this rank's rows with ``top`` rows of the rank above and
    ``bottom`` rows of the rank below (zeros past the image's edges).  The
    backward sends each halo row's gradient to the rank owning the row and
    adds it there."""

    @staticmethod
    def forward(ctx, x, top, bottom, axis):
        ctx.top, ctx.bottom, ctx.axis = top, bottom, axis
        h = x.shape[2]
        # slot: the rows the rank below needs (my last `top`), then the rows
        # the rank above needs (my first `bottom`); zeros from an empty
        # block, which stand in for the image's bottom edge above it
        if h:
            slot = torch.cat([x[:, :, h - top:], x[:, :, :bottom]], dim=2)
        else:
            slot = x.new_zeros((*x.shape[:2], top + bottom, x.shape[3]))
        slots = gather(slot, axis)
        i, n = axis.index, axis.size
        above = slots[i - 1, :, :, :top] if i > 0 else x.new_zeros((*x.shape[:2], top, x.shape[3]))
        below = (slots[i + 1, :, :, top:] if i < n - 1
                 else x.new_zeros((*x.shape[:2], bottom, x.shape[3])))
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        top, bottom, axis = ctx.top, ctx.bottom, ctx.axis
        h = g.shape[2] - top - bottom
        # slot: the gradient of my top halo (rows of the rank above), then of
        # my bottom halo (rows of the rank below)
        slots = gather(torch.cat([g[:, :, :top], g[:, :, top + h:]], dim=2).contiguous(), axis)
        dx = g[:, :, top:top + h].clone()
        i, n = axis.index, axis.size
        if i < n - 1 and top and h:
            dx[:, :, h - top:] += slots[i + 1, :, :, :top]
        if i > 0 and bottom and h:
            dx[:, :, :bottom] += slots[i - 1, :, :, top:]
        return dx, None, None, None


def halo_rows(kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """(rows above, rows below) that a shard's block of a conv's output
    reads beyond the block's input rows."""
    return padding, max(kernel - stride - padding, 0)


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: Tuple[int, int], padding: Tuple[int, int], axis: Axis,
                layer: str = "conv") -> torch.Tensor:
    """``F.conv2d(x, weight, bias, stride, padding)`` of the whole image,
    restricted to this rank's rows of the output, from this rank's rows of
    ``x`` and the halo rows of its neighbours."""
    kh, sh, ph = weight.shape[2], stride[0], padding[0]
    top, bottom = halo_rows(kh, sh, ph)
    h = x.shape[2]
    if h == 0:
        return _empty_conv(x, weight, stride, padding, top, bottom, axis)
    if h % sh:
        raise ValueError(f"{layer}: {h} rows a shard do not divide by the stride {sh}; "
                         "the image height must divide by (shards x 64)")
    if max(top, bottom) > h:
        raise ValueError(f"{layer}: a {kh}-row kernel reaches {max(top, bottom)} rows past a "
                         f"shard of {h} rows")
    if top or bottom:
        x = _Halo.apply(x, top, bottom, axis)
    return F.conv2d(x, weight, bias, stride, (0, padding[1]))


def _empty_conv(x: torch.Tensor, weight: torch.Tensor, stride: Tuple[int, int],
                padding: Tuple[int, int], top: int, bottom: int, axis: Axis) -> torch.Tensor:
    """The conv's output block of a rank that holds no rows: it joins the
    halo exchange (and, in the backward, its return), and yields no rows,
    tied to ``x`` and ``weight`` by a zero so that its backward runs."""
    if top or bottom:
        x = _Halo.apply(x, top, bottom, axis)
    w_out = (x.shape[3] + 2 * padding[1] - weight.shape[3]) // stride[1] + 1
    tie = x.sum() * 0.0 + weight.sum() * 0.0
    return x.new_zeros((x.shape[0], weight.shape[0], 0, w_out)) + tie


def mesh_axis(mesh, name: str) -> Axis:
    """The axis ``name`` of a ``DeviceMesh`` as this rank sees it."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {name!r}; its axes are {mesh.mesh_dim_names}")
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


class _ParamLowerBound(torch.autograd.Function):
    """``lower_bound`` of a replicated parameter in a sharded step: the gate
    (pass where ``x >= bound`` or the gradient points up) must see the
    global batch's gradient, not this rank's part, since gating is not
    additive.  The backward reduces the gradient as ``reduce_gradients_``
    does (summed over the row shards, averaged over the batch ranks), gates
    it, and returns this rank's share of it: the gated gradient over the
    number of row shards, which that reduction sums back."""

    @staticmethod
    def forward(ctx, x, bound, where):
        ctx.save_for_backward(x)
        ctx.bound, ctx.where = bound, where
        return x.clamp(min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        where = ctx.where
        g = g.contiguous().clone()
        for axis in (where.rows, where.batch):
            if axis is not None:
                all_reduce_(g, axis)
        if where.batch is not None:
            g /= where.batch.size
        pass_through = (x >= ctx.bound) | (g < 0.0)
        share = 1 if where.rows is None else where.rows.size
        return g.masked_fill(~pass_through, 0.0) / share, None, None


def param_lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``ops.bounds.lower_bound`` of a parameter, gated on the global
    gradient under a shard (see ``_ParamLowerBound``)."""
    s = _CURRENT.get()
    if s is None or (s.batch is None and s.rows is None) or not x.requires_grad:
        return lower_bound(x, bound)
    return _ParamLowerBound.apply(x, bound, s)
