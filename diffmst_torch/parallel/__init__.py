"""The device mesh and its ranks (port of ``diffmst_tpu/parallel``)."""

from diffmst_torch.parallel.launch import default_backend, init_rank, launch, rank_device
from diffmst_torch.parallel.mesh import (
    Mesh,
    assert_mesh_divisible,
    batch_rows,
    bn_group,
    bound,
    check_replicas,
    gather_tracks,
    make_mesh,
    shard_batch,
    track_slice,
)

__all__ = [
    "Mesh",
    "assert_mesh_divisible",
    "batch_rows",
    "bn_group",
    "bound",
    "check_replicas",
    "default_backend",
    "gather_tracks",
    "init_rank",
    "launch",
    "make_mesh",
    "rank_device",
    "shard_batch",
    "track_slice",
]
