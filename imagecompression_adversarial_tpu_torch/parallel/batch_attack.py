"""Data-parallel corpus attack (port of
``imagecompression_adversarial_tpu/parallel/batch_attack.py``).

A batch of images is split along the mesh's ``dp`` axis; every rank runs
the batched attack (``attacks/rd.py::make_batch_attack_fn``) on its block,
and every rank gets every image's results back.  The images are
independent, so the attack itself needs no collective; the results are
gathered with one all-gather a result.

Image ``i`` draws its initial noise (where the config draws one) from a
``torch.Generator`` seeded with ``i``; JAX's splits ``PRNGKey(0)`` into one
key an image.  The two streams differ (ROADMAP Queue C).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..attacks.common import RDAttackConfig
from ..attacks.rd import make_batch_attack_fn
from ..ops import shard
from .mesh import mesh_device


def make_sharded_attack_fn(model, cfg: RDAttackConfig, mesh) -> Callable[..., Dict[str, np.ndarray]]:
    """Build ``attack(xs, seeds=None) -> results`` for a host batch ``xs``
    (``(B, 3, H, W)``, numpy or tensor) split over ``dp``; ``B`` need not
    divide by the axis size: the batch is padded by repeating its last
    image, and the pad is stripped from the results.  Runs in every rank;
    each gets every image's results, as numpy arrays with a leading axis
    of size B.  ``seeds[i]`` (default ``i``) seeds image ``i``'s generator.
    """
    batched = make_batch_attack_fn(model, cfg)
    dp = shard.mesh_axis(mesh, "dp")
    device = mesh_device(mesh)

    def attack(xs, seeds: Optional[Sequence[int]] = None) -> Dict[str, np.ndarray]:
        xs = torch.as_tensor(xs)
        b = xs.shape[0]
        seeds = list(range(b)) if seeds is None else [int(s) for s in seeds]
        pad = (-b) % dp.size
        if pad:
            xs = torch.cat([xs, xs[-1:].expand(pad, -1, -1, -1)])
            seeds += [seeds[-1]] * pad
        block = xs.shape[0] // dp.size
        lo = dp.index * block
        mine = xs[lo:lo + block].to(device, torch.float32)
        gens = [torch.Generator(device=device).manual_seed(s) for s in seeds[lo:lo + block]]
        out = batched(mine, gens)
        return {k: shard.gather(v.detach(), dp).reshape(-1, *v.shape[1:])[:b].cpu().numpy()
                for k, v in out.items()}

    return attack
