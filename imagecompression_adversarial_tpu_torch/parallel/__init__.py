"""Parallelism layer (port of ``imagecompression_adversarial_tpu/parallel``):
one process per rank over ``torch.distributed`` (``launch.run_spmd``),
device meshes, the dp corpus attack, overlap tiles and exact row
sharding (the attack with any metric, in-loop defense but the latent
clip, ``-p`` or ``split_eval``).  The dp and dp x sp training steps,
``recompress`` included, are ``train/step.py::train_step(..., mesh=)``,
and their inner attack ``attacks/rd.py::make_adv_example_fn(..., mesh=)``."""

from .batch_attack import make_sharded_attack_fn
from .launch import choose_backend, collective_report, run_spmd
from .mesh import (
    batch_row_sharding,
    batch_sharding,
    local_part,
    make_mesh,
    mesh_device,
    mesh_shape,
    replicate,
    replicated,
    shard_batch,
)
from .spatial import tile_image, tiled_forward, untile_image
from .spatial_shard import (
    check_row_shardable,
    make_spatial_attack_fn,
    make_spatial_forward,
    row_sharding,
)

__all__ = [
    "batch_row_sharding",
    "batch_sharding",
    "check_row_shardable",
    "choose_backend",
    "collective_report",
    "local_part",
    "make_mesh",
    "make_sharded_attack_fn",
    "make_spatial_attack_fn",
    "make_spatial_forward",
    "mesh_device",
    "mesh_shape",
    "replicate",
    "replicated",
    "row_sharding",
    "run_spmd",
    "shard_batch",
    "tile_image",
    "tiled_forward",
    "untile_image",
]
