"""The (dp, mp) device mesh over torch.distributed ranks, and its collectives.

Port of ``diffmst_tpu/parallel/mesh.py``. JAX lays one program over a
``jax.sharding.Mesh`` of devices; here every rank is a process with one
device, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group with the axes ("dp", "mp"). Rank r
sits at (r // mp, r % mp), as JAX's ``reshape(dp, mp)`` lays devices out.

  * ``dp``: data parallel. Each dp row takes its rows of the global batch
    (``shard_batch``). The gradients are averaged over dp, and BatchNorm's
    statistics are the global batch's: JAX's jitted step sees the global
    batch (``diffmst_tpu/parallel/mesh.py:27-30``).
  * ``mp``: the track axis. Within a dp row every mp rank holds the row's
    whole batch, as JAX's ``batch_sharding`` (``P("dp")``) replicates it
    over mp. The console's per-track chain and the track encoder run on
    this rank's tracks (``track_slice``), and their results are gathered
    along tracks (``gather_tracks``). What follows the gather runs
    replicated over mp: JAX's ``shard_map`` regions and their global-view
    rest.

The collectives are all-reduces (``torch.distributed.all_reduce``), which
NCCL and gloo both take on CUDA tensors, with the autograd each needs:

  * ``gather_tracks``: forward, an all-reduce over mp of a zero-filled
    buffer that holds this rank's slice; backward, this rank's slice of the
    cotangent. Every mp rank holds the same cotangent there, since all that
    follows the gather is replicated: a sum over the ranks would count it
    mp times.
  * ``track_slice`` of a replicated tensor that takes a gradient (the
    console chain's parameters, which the controller predicts): forward,
    this rank's slice; backward, the all-reduce over mp of the zero-filled
    cotangent, so that the replicated tensor gets its whole cotangent.

BatchNorm's statistics across ranks (``models/cnn14.py::batch_norm``)
all-reduce their sums forward and the cotangents' sums backward.

``bound(mesh)`` binds the mesh that a train step runs over (JAX binds axis
names inside a transform): ``bn_group`` then resolves a BatchNorm's axis
names to a process group. A mesh needs a process group: start the ranks
with ``parallel.launch`` or ``torchrun`` (``parallel/launch.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "assert_mesh_divisible",
    "shard_batch",
    "batch_rows",
    "track_slice",
    "gather_tracks",
    "bound",
    "bn_group",
    "check_replicas",
]

AXES = ("dp", "mp")
AxisNames = Optional[Union[str, Sequence[str]]]


class Mesh:
    """A (dp, mp) mesh of ranks: ``shape`` ({"dp": dp, "mp": mp}, as JAX's
    ``Mesh.shape``), this rank's ``coordinate`` (dp index, mp index) and the
    process group of any set of its axes (``group``)."""

    axis_names = AXES

    def __init__(self, device_mesh) -> None:
        self.device_mesh = device_mesh
        dp, mp = (int(device_mesh.size(i)) for i in range(2))
        self.shape = {"dp": dp, "mp": mp}
        self.rank = dist.get_rank()
        self.coordinate: Tuple[int, int] = tuple(int(c) for c in device_mesh.get_coordinate())
        self.backend = dist.get_backend()

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["mp"]

    def axes_size(self, axes: Iterable[str]) -> int:
        n = 1
        for a in set(axes):
            n *= self.shape[a]
        return n

    def group(self, axes: Iterable[str]):
        """The process group of this rank's ranks along ``axes``: its dp
        column for ("dp",), its dp row for ("mp",), every rank for both."""
        axes = set(axes)
        if axes - set(AXES) or not axes:
            raise ValueError(f"mesh axes are {AXES}, got {sorted(axes)}")
        if axes == set(AXES):
            return dist.group.WORLD  # the mesh spans the default group
        return self.device_mesh.get_group(axes.pop())


def make_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """A ("dp", "mp") mesh over the ranks of the default process group, on
    the type of this rank's device (``parallel.launch.rank_device``).

    With ``dp`` None, every rank but the mp split goes to data parallelism."""
    from diffmst_torch.parallel.launch import rank_device

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start the ranks with diffmst_torch.parallel.launch "
            "or torchrun (diffmst_torch.parallel.init_rank joins one)"
        )
    n = dist.get_world_size()
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp}*{mp} != device count {n}")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(rank_device().type, (dp, mp), mesh_dim_names=AXES))


def assert_mesh_divisible(mesh, batch: int, tracks: int, where: str) -> None:
    """A clear error where the global ``batch`` or the ``tracks`` do not
    split over the mesh's dp and mp axes (JAX's words, ``diffmst_tpu/
    parallel/mesh.py:51-74``)."""
    dp = mesh.shape.get("dp", 1)
    mp = mesh.shape.get("mp", 1)
    if batch % dp != 0:
        raise ValueError(
            f"{where}: global batch {batch} not divisible by dp={dp}; "
            "use a batch size that is a multiple of the dp mesh axis"
        )
    if tracks % mp != 0:
        raise ValueError(
            f"{where}: track axis {tracks} not divisible by mp={mp}; "
            "set max_tracks to a multiple of the mp mesh axis (padded "
            "tracks are masked and render to silence, so rounding up is "
            "behavior-neutral)"
        )


def batch_rows(mesh, local_bs: int) -> Tuple[int, slice]:
    """(the global batch size, this rank's rows of it) for ``local_bs``
    rows a rank."""
    return local_bs * mesh.shape["dp"], slice(mesh.coordinate[0] * local_bs, (mesh.coordinate[0] + 1) * local_bs)


def shard_batch(batch, mesh):
    """This rank's part of a global ``Batch``: the rows of its dp index of
    ``tracks``, ``track_padding`` and ``ref_mix``, whole over mp (JAX's
    ``batch_sharding``/``shard_batch``, ``diffmst_tpu/parallel/mesh.py:
    97-121``). ``instrument_id`` and ``stereo_info`` stay the global batch's:
    they stay on the host, and the host-side KE sampler draws the global
    batch's reference mixes from them (``System``)."""
    bs, tracks = batch.tracks.shape[:2]
    assert_mesh_divisible(mesh, bs, tracks, "shard_batch")
    _, rows = batch_rows(mesh, bs // mesh.shape["dp"])
    return batch._replace(tracks=batch.tracks[rows], track_padding=batch.track_padding[rows],
                          ref_mix=batch.ref_mix[rows])


class _SliceTracks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, mp):
        k = x.shape[1] // mp
        ctx.group, ctx.index, ctx.k, ctx.shape = group, index, k, x.shape
        return x.narrow(1, index * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(1, ctx.index * ctx.k, ctx.k).copy_(g)
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


def track_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's tracks of ``x`` (the track axis 1): its mp index's share.
    ``x`` is replicated over mp; where it takes a gradient, the backward
    puts every mp rank's slice of the cotangent together (an all-reduce
    over mp), so that what precedes the slice sees its whole cotangent on
    every mp rank (the dual of ``gather_tracks``)."""
    mp, index = mesh.shape["mp"], mesh.coordinate[1]
    if torch.is_grad_enabled() and x.requires_grad:
        return _SliceTracks.apply(x, mesh.group(("mp",)), index, mp)
    k = x.shape[1] // mp
    return x.narrow(1, index * k, k)


class _GatherTracks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, mp):
        ctx.index, ctx.k = index, x.shape[1]
        shape = list(x.shape)
        shape[1] *= mp
        full = x.new_zeros(shape)
        full.narrow(1, index * ctx.k, ctx.k).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.index * ctx.k, ctx.k).contiguous(), None, None, None


def gather_tracks(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every mp rank's ``track_slice`` of a tensor put back together along
    the track axis 1; the gradient of this rank's slice is its slice of the
    cotangent (see the module docstring)."""
    return _GatherTracks.apply(x.contiguous(), mesh.group(("mp",)), mesh.coordinate[1], mesh.shape["mp"])


_BOUND: list = [None]


@contextlib.contextmanager
def bound(mesh):
    """Bind ``mesh`` as the one the code inside runs over (None: no mesh).
    A module-level binding, not a thread's: the backward pass, whose
    recomputed forwards reduce BatchNorm statistics too, may run on
    autograd's device thread."""
    saved = _BOUND[0]
    _BOUND[0] = mesh
    try:
        yield mesh
    finally:
        _BOUND[0] = saved


def bn_group(axis_name: AxisNames):
    """The process group a train-mode BatchNorm built with ``axis_name``
    reduces its statistics over under the bound mesh: the dp axis always
    (every rank holds part of the global batch, which JAX's step sees
    whole), and the axes ``axis_name`` names. None (local statistics) with
    no mesh bound or a group of one rank."""
    mesh = _BOUND[0]
    if mesh is None:
        return None
    names = {axis_name} if isinstance(axis_name, str) else set(axis_name or ())
    axes = {"dp"} | names
    if mesh.axes_size(axes) == 1:
        return None
    return mesh.group(axes)


@torch.no_grad()
def check_replicas(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Broadcast rank 0's ``tensors`` to every rank of ``mesh`` and check
    that they equal this rank's: a replicated state that differs across
    ranks (another seed, another checkpoint) raises ``ValueError`` on every
    rank at once."""
    differs = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.reshape(-1))
    for dtype in sorted(by_dtype, key=str):
        flat = torch.cat(by_dtype[dtype])
        theirs = flat.clone()
        dist.broadcast(theirs, src=0, group=mesh.group(AXES))
        if not torch.equal(theirs, flat):
            differs += 1.0
    dist.all_reduce(differs, group=mesh.group(AXES))
    if float(differs):
        raise ValueError(
            "the replicated state differs across the mesh's ranks: every rank must build the model "
            "from the same seed and restore the same checkpoint"
        )
