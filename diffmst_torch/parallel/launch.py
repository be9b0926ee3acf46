"""Start the ranks of a mesh from one command, one process a rank.

Lightning's DDP starts a process per device for ``trainer.devices: N``;
``launch(fn, n)`` does so here: it spawns ``n`` processes
(``torch.multiprocessing``, the "spawn" method), each joins one process
group, runs ``fn(*args)`` on its device and hands its return value back
(``torch.save`` into the launch's temporary directory): ``launch`` returns
the ranks' values in rank order. The ranks meet through a ``FileStore`` in
that directory, so no TCP port is fixed and launches do not collide.

Each rank's environment is what ``torchrun`` gives its workers (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``), so
code run under ``torchrun`` takes the same path: ``init_rank`` joins the
group from the environment (``env://``, torchrun's rendezvous) where no
store is named. Rank r runs on ``cuda:r % device_count`` (``LOCAL_RANK``'s),
or on the CPU when the caller asks for it.

A spawned rank computes on the host with its share of the launching
process's threads (``torch.get_num_threads() // nprocs``, at least one), as
``torchrun`` keeps its workers from oversubscribing the cores.

Backend: NCCL on the card, gloo on the CPU, or the one the caller names (two
ranks that share one card need gloo: NCCL refuses them). A missing NCCL
raises; nothing falls back to gloo. A rank that raises, or whose collective
fails, ends the launch with its error: the others are stopped, nothing is
caught. One rank runs in the calling process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["launch", "init_rank", "rank_device", "default_backend"]

_STORE_ENV = "DIFFMST_RANK_STORE"
_DEVICE = [None]


def default_backend(device_type: str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks; no NCCL on a CUDA build
    without it raises."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("CUDA ranks need NCCL, which this torch build lacks")
        return "nccl"
    return "gloo"


def rank_device() -> torch.device:
    """The device ``init_rank`` gave this rank (the CUDA device when none
    was given)."""
    return _DEVICE[0] if _DEVICE[0] is not None else torch.device("cuda")


def init_rank(backend: Optional[str] = None, device: Optional[str] = None) -> torch.device:
    """Join the process group of this rank from its environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; the launch's store, else ``env://``)
    and return its device: ``cuda:LOCAL_RANK % device_count``, or the CPU
    for ``device="cpu"``. Without a card and without ``device="cpu"`` it
    raises, as every entry point of the port does."""
    from diffmst_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros((), device=dev)  # the context exists before the DeviceMesh looks for one
    _DEVICE[0] = dev
    backend = backend or default_backend(dev.type)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    store = os.environ.get(_STORE_ENV)
    init = f"file://{store}" if store else "env://"
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=30))
    return dev


@contextlib.contextmanager
def _rank_environment(rank: int, world: int, store: str):
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK", _STORE_ENV)
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0", **{_STORE_ENV: store})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_rank(rank: int, fn: Callable, args: tuple, world: int, tmp: str, backend: Optional[str],
              device: Optional[str], threads: Optional[int] = None) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    with _rank_environment(rank, world, os.path.join(tmp, "store")):
        init_rank(backend, device)
        try:
            out = fn(*args)
            torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
            _DEVICE[0] = None


def launch(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
           device: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` ranks (see the module docstring) and
    return each rank's value. ``fn`` must be importable by name (a module's
    top-level function): the spawned processes import it."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="diffmst_ranks_") as tmp:
        if nprocs == 1:
            _run_rank(0, fn, args, 1, tmp, backend, device)
        else:
            threads = max(1, torch.get_num_threads() // nprocs)
            mp.start_processes(_run_rank, args=(fn, args, nprocs, tmp, backend, device, threads), nprocs=nprocs,
                               join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(nprocs)]
