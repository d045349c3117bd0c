"""Exact spatial model parallelism: one image's rows split across ranks
(port of ``imagecompression_adversarial_tpu/parallel/spatial_shard.py``).

JAX annotates the rows with a mesh axis and lets GSPMD insert the conv
halos and the loss psums.  Here each rank of the mesh's ``sp`` axis runs
the whole codec on its block of rows under ``ops/shard.py``'s row shard:

* every ``Conv`` fetches the rows its kernel reaches across the block's
  edges from the neighbouring ranks (a 3x3 stride-1 conv 1 row each side,
  a 5x5 stride-2 conv 2 above and 1 below, a 7x7 stride-1 conv 3 each
  side), with zero rows only at the image's top and bottom; every
  ``Deconv`` at stride 2 (k=5, and hific's and tic's k=3) runs as its
  exact subpixel 3x3 conv (1 row each side), then ``depth_to_space``;
  GDN/IGDN and the entropy models are pointwise and need none;
* cheng2020's blocks compose those: residual blocks and units are 1x1
  and 3x3 stride-1 convs (no halo, and 1 row each side) and 3x3 stride-2
  convs (1 row above); a sub-pixel conv is a 3x3 conv, then a shuffle
  within each row; the attention block's sigmoid gate, products and sums
  are pointwise; the context model is a halo'd 5x5 masked conv, the
  entropy parameters 1x1 convs, the GMM pointwise;
* the adapter families: hific's ``ChannelNorm`` normalises over the
  channels of each pixel, so it is pointwise, and its blocks compose
  convs; invcompress's squeezes pair rows within a block, which is exact
  while each block starts on an even row at all four levels (``H`` a
  multiple of ``sp x 64`` gives it; ``squeeze2`` checks it), and its
  invertible 1x1 convs and coupling splits are pointwise; tic's blocks
  hold whole 4-row windows (at 1/16 scale ``sp x 64`` rows give 4k a
  block; ``SwinBlock`` checks it), the shifted block's roll of the rows
  by -2 and back wraps across the ranks (``shard.roll_rows``: each rank
  takes the first 2 rows of the next), and its layer norms, Dense layers
  and MLP act on each token alone; fic's ``Context4`` takes its
  checkerboard masks from the block's global row offset; nlaic's
  non-local block attends from this rank's queries to the keys and
  values of every rank (``shard.shared_rows``, whose backward sums every
  rank's gradient of a rank's rows);
* every reduction on the path is the whole image's: the attack's losses
  and its two-phase decision, the evaluation's MSEs and the rate; the
  final MS-SSIM gathers the rows once.  The MS-SSIM attack metric gathers
  the 3-channel images every step (``ops/shard.py::all_rows``), whose
  backward hands each rank its own rows: exact, and at 4096x3072 151 MB a
  gather against GiBs of codec activations, where a halo rule for its
  11-row windows at five scales would also need its pools and per-scale
  means made global;
* the in-loop defenses (``defenses/self_ensemble.py``): the bit-depth
  reduction is pointwise; the resize gathers the 3-channel image
  (``shard.shared_rows``), resizes the whole image and keeps this rank's
  rows (``shard.own_rows``); the self-ensemble gathers it, runs the codec
  on each rank's row block of each of the 8 dihedral variants, gathers
  the 8 reconstructions and picks the winner on the whole image, keeping
  this rank's rows of it.  At 4096x3072 a gather is 151 MB a rank, the
  ensemble's nine 1.36 GB;
* ``-p`` pads the whole image (a gather with no gradient), each rank runs
  the clean forward on its rows of the padded image, and the cropped
  reconstruction is gathered and split again into the unpadded blocks;
  ``bpp_ori`` sums the ranks' rates over the unpadded ``H x W``.  The
  padded height ``H + 2p``, like the ensemble's rotated height ``W``, is
  split by ``ops/shard.py::row_blocks``: where it does not divide by ``sp
  x 64`` every rank but the last takes ``ceil(rows / (sp x 64)) x 64``
  rows and the last the rest, none at all at ``W = 128, sp = 4`` (64, 64,
  0, 0): such a rank runs the codec on an empty block and joins every
  halo exchange and gather, and the gathers take blocks of any height;
* the attack's noise, Adam state and activations stay row-sharded: ``im_``
  comes back as each rank's rows;
* a ``split_eval`` config checkpoints the loop by stage on each rank's
  rows: the recompute fetches its halos and gathers again.

The result equals the one-process run up to the order of float sums.
``H`` must divide by ``sp x 64``, as JAX asserts, so that each block
starts on an even row at every stride-2 stage; the padded height ``H +
2p`` and the ensemble's ``W`` must divide by 64, as the codec needs on one
process too (else every rank raises, naming the size, before the first
collective).  Layers with no halo rule raise, naming the layer (the
``debug`` fixture's stride-1 transposed conv).  The latent clip
(``defend_in_loop='clip'``) raises as JAX's does: this attack takes no
``latent_transform``.  Nothing falls back to an unsharded run.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..attacks.common import RDAttackConfig, init_noise
from ..attacks.rd import make_attack_fn
from ..entropy.factorized import EntropyBottleneck
from ..models import codecs, fic, hific, invcompress, layers, nlaic, tic
from ..ops import shard
from .mesh import axis_sharding, local_part, mesh_device

#: Module types whose forward is exact on a block of rows: convs (halo'd),
#: pointwise layers, and containers that only compose them.
ROW_SHARDABLE = (
    layers.Conv, layers.MaskedConv, layers.Deconv, layers.GDN, layers.SubpelConv,
    layers.ResidualBlock, layers.ResidualBlockWithStride, layers.ResidualBlockUpsample,
    layers.ResidualUnit, layers.AttentionBlock,
    nn.Sequential, nn.ReLU, nn.LeakyReLU, nn.PixelShuffle, EntropyBottleneck,
    codecs.FactorizedPrior, codecs.ScaleHyperprior, codecs.JointAutoregressive,
    codecs.Cheng2020Anchor, codecs.Cheng2020Attention, codecs.Cheng2020AttnGMM,
    hific.HiFiC, hific.HiFiCEncoder, hific.HiFiCGenerator, hific.HiFiCResidualBlock,
    hific.ChannelNorm,
    invcompress.InvCompress, invcompress.InvComp, invcompress.CouplingLayer,
    invcompress.InvertibleConv1x1, invcompress.Bottleneck, invcompress.ZeroConv,
    tic.TIC, tic.SwinBlock, tic.WindowAttention, tic.Dense, nn.LayerNorm,
    fic.FIC, fic.Context4,
    nlaic.NLAIC, nlaic.NLAM, nlaic.NonLocalBlock,
)


def row_sharding(mesh, axis: str = "sp"):
    """NCHW tensors with their rows (dim 2) split along ``axis``."""
    return axis_sharding(mesh, axis, 2)


def check_row_shardable(model: nn.Module) -> None:
    """Raise naming the layers of ``model`` that have no halo rule."""
    bad = {}
    for name, m in model.named_modules():
        if type(m) not in ROW_SHARDABLE:
            bad.setdefault(type(m).__name__, name or "<model>")
    if bad:
        found = ", ".join(f"{k} ({v})" for k, v in list(bad.items())[:4])
        raise ValueError(f"{type(model).__name__} cannot be row-sharded: no halo rule for {found}")


def _check_height(h: int, n_sp: int) -> None:
    if h % (n_sp * shard.ROW_MULTIPLE):
        raise ValueError(f"H={h} must divide by sp*{shard.ROW_MULTIPLE}="
                         f"{n_sp * shard.ROW_MULTIPLE} (pad-to-64 upstream, then pick sp)")


def _check_aligned(rows: int, what: str) -> None:
    """The codec runs on ``rows`` rows split by ``row_blocks``: a multiple
    of 64, which one process needs too, keeps every block on whole rows at
    each stride-2 stage (checked on every rank before any collective)."""
    if rows % shard.ROW_MULTIPLE:
        raise ValueError(f"{what} gives {rows} rows, which must divide by {shard.ROW_MULTIPLE}")


def make_spatial_forward(model, mesh, axis: str = "sp") -> Callable[[torch.Tensor], Dict]:
    """``forward(x) -> result``: the ``dequantize`` forward of the whole
    image ``x`` (``(1, 3, H, W)``, on the host or the card) with its rows
    split over ``axis``; every tensor of the result is this rank's rows.
    Runs in every rank."""
    check_row_shardable(model)
    rows = shard.mesh_axis(mesh, axis)
    device = mesh_device(mesh)
    placements = row_sharding(mesh, axis)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> Dict:
        _check_height(x.shape[2], rows.size)
        mine = local_part(mesh, torch.as_tensor(x), placements).to(device)
        with shard.sharded(rows=rows, even_rows=True):
            return model(mine.contiguous(memory_format=torch.channels_last),
                         quant_mode="dequantize")

    return forward


def make_spatial_attack_fn(model, cfg: RDAttackConfig, mesh,
                           axis: str = "sp") -> Callable[..., Dict]:
    """RD attack on ONE image with its rows split over ``axis``:
    ``attack(x, generator=None) -> results`` for the whole image ``x``
    (``(1, 3, H, W)``); the scalars are the whole image's, ``im_`` and the
    other images this rank's rows.  The initial noise, where the config
    draws one, is drawn for the whole image and split.  Any attack metric;
    a ``split_eval`` config runs the split attack; any in-loop defense but
    the latent clip, and ``-p``.  Runs in every rank.
    """
    check_row_shardable(model)
    single = make_attack_fn(model, cfg)
    rows = shard.mesh_axis(mesh, axis)
    device = mesh_device(mesh)
    placements = row_sharding(mesh, axis)

    def attack(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict:
        _check_height(x.shape[2], rows.size)
        totals = [x.shape[2]]
        if cfg.pad:
            _check_aligned(x.shape[2] + 2 * cfg.pad, f"-p {cfg.pad} on H={x.shape[2]}")
            totals.append(x.shape[2] + 2 * cfg.pad)
        if cfg.defend_in_loop == "ensemble":
            _check_aligned(x.shape[3], "the self-ensemble's rotated variants (W)")
            totals.append(x.shape[3])
        x = torch.as_tensor(x)
        noise = init_noise(tuple(x.shape), single.cfg, generator, device)
        mine = local_part(mesh, x, placements).to(device)
        noise = local_part(mesh, noise, placements)
        even = all(t % (rows.size * shard.ROW_MULTIPLE) == 0 for t in totals)
        with shard.sharded(rows=rows, even_rows=even):
            return single.run(mine, noise)

    return attack
