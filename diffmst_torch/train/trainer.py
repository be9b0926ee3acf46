"""Training loop: epochs, curriculum flags, validation, checkpoints, prefetch.

Port of ``diffmst_tpu/train/trainer.py``, the Lightning-Trainer role of the
reference: a Python loop around ``System.train_step``, which updates the
System in place.

  * curriculum: the effect flags of each epoch (``System.effect_flags``);
  * prefetch: a background thread walks the host dataloader and puts each
    batch on the device while the card runs the previous step;
  * logging: every ``log_every_n_steps`` steps the metrics reach the host
    (the only synchronization of the loop), with steps/s and the audio
    realtime factor over the window since the last log; the same tags
    ("sanity", "train", "val", "test", "epoch") and keys as JAX reach
    ``_log`` and the callbacks;
  * checkpoints: "last" after every epoch and every ``ckpt_every_n_steps``,
    "best" on the lowest validation loss (``utils.checkpoint.save_state``,
    with the ``next_epoch``/``step``/``steps_per_epoch`` meta); ``fit(resume=
    path)`` restores the System and starts at the meta's ``next_epoch``;
  * profiling: with ``profile_steps`` (a range of batch indices within an
    epoch, of groups with ``fused_steps``) a ``torch.profiler`` trace
    starts before step ``profile_steps.start`` and stops after step
    ``profile_steps.stop`` has run (the card synchronized first), JAX's
    bounds; each epoch's trace is a Chrome trace in ``profile_dir``
    (``utils/profiler.py::trace``) that ``utils/trace_ops.py`` reads. The
    System's ``system.*`` ranges (``record_function``) are in it;
  * ``fused_steps`` K > 1: each group of K batches runs as one unit
    (``train/fused.py``): on the card one replay of a CUDA graph of K
    steps, built for each epoch's ``EffectFlags`` and batch shape when
    first seen (the flags only move forward, so the last flags' graphs are
    freed then; a ``fused:`` line a graph); on the CPU the same staged
    steps eagerly. Batch order, random draws and
    updates are those of K sequential steps; an epoch whose batches do not
    fill its groups raises ``ValueError``, as JAX's does. The log and
    checkpoint points are JAX's: after the group in which the step count
    passes a multiple of ``log_every_n_steps`` (``ckpt_every_n_steps``),
    with the group's last step's metrics. The prefetch thread holds a lock
    around its copies, which a capture takes;

Random streams (JAX splits one key per step; the port draws from
``torch.Generator``s, by these rules):

  * training: ``system.generator``, seeded ``seed`` when ``fit`` starts; a
    resumed fit continues the checkpoint's stream;
  * the sanity check: a generator seeded ``seed + 2``, so it leaves the
    training stream alone and same-seed runs are identical with any
    ``num_sanity_val_steps``;
  * validation in ``fit``: a generator seeded by one 63-bit draw from the
    training stream (JAX's ``split``); with ``deterministic_val``, batch i
    of every pass draws from a generator seeded
    ``_fold_in(seed + 1, i)`` instead, so every pass draws the same;
  * ``validate`` and ``test``: as validation, from a training stream seeded
    ``seed``.

A mesh (``Trainer(mesh=)``, ``parallel.make_mesh``; JAX ``trainer.py:95,
:155-161``): every rank runs this loop over the same global batches (the
datamodule shards songs by host, not by rank), and the prefetch thread takes
the rank's rows on the host before the upload (``parallel.shard_batch``).
The System steps over the mesh (``System.distribute``): its metrics are the
global batch's on every rank. Rank 0 alone prints, logs, calls the
callbacks, traces and writes checkpoints; every rank restores them. The
state is replicated, so a mesh fit's checkpoint is a single process's, and
the other way round. ``fit`` checks the ranks' parameters against rank 0's
first (``System.check_replicas``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from diffmst_torch.parallel.mesh import shard_batch
from diffmst_torch.train.fused import FusedSteps
from diffmst_torch.train.system import Batch, System
from diffmst_torch.utils.checkpoint import load_meta, restore_state, save_state
from diffmst_torch.utils.device import resolve_device
from diffmst_torch.utils.profiler import trace

__all__ = ["Trainer"]

_SAMPLE_RATE = 44100.0


def _to_batch(raw, device: torch.device, mesh=None) -> Batch:
    """A collated host batch (tracks, stereo, instr, padding, mix, names) as a
    ``Batch`` on ``device``, but for the instrument ids and stereo flags,
    which stay on the host: only the host-side KE sampler reads them. Under
    a ``mesh``, this rank's share of it (``parallel.shard_batch``, taken on
    the host)."""
    tracks, stereo, instr, padding, mix, _names = raw
    batch = Batch(*(torch.as_tensor(a) for a in (tracks, instr, stereo, padding, mix)))
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    return batch._replace(tracks=batch.tracks.to(device), track_padding=batch.track_padding.to(device),
                          ref_mix=batch.ref_mix.to(device))


def _prefetch(loader, device: torch.device, depth: int = 2, lock=None, mesh=None) -> Iterator[Batch]:
    """Batches of ``loader`` on ``device``, made by a background thread.

    The thread walks the host dataloader (decode, loudness gating, buffer
    reloads, collate) and copies each batch to the device while the consumer
    runs steps; at most ``depth`` batches wait. A loader's exception is
    raised in the consumer. Copies go to the device's default stream, in
    order with the steps, each under ``lock`` where one is given (a CUDA
    graph's capture holds it: no other thread may call the runtime then).
    Under a ``mesh`` each batch is this rank's share (``_to_batch``).
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for raw in loader:
                if stop.is_set():
                    return
                with lock if lock is not None else contextlib.nullcontext():
                    batch = _to_batch(raw, device, mesh)
                put(batch)
            put(end)
        except BaseException as exc:  # noqa: BLE001 -- re-raised by the consumer
            put(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()  # a consumer that stops early releases the producer
        t.join(timeout=10.0)


def _split(generator: torch.Generator) -> torch.Generator:
    """A new CPU generator seeded by one 63-bit draw from ``generator``."""
    seed = int(torch.randint(0, 2**63 - 1, (), generator=generator, device=generator.device))
    return torch.Generator().manual_seed(seed)


def _fold_in(base: int, i: int) -> int:
    """The seed of batch ``i`` of a deterministic validation pass."""
    return int(np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def _drawing_from(system: System, generator: torch.Generator):
    """Let ``system`` draw its reference mixes from ``generator`` meanwhile."""
    saved = system.generator
    system.generator = generator
    try:
        yield
    finally:
        system.generator = saved


class Trainer:
    def __init__(
        self,
        system: System,
        datamodule,
        max_epochs: Optional[int] = None,
        ckpt_dir: str = "checkpoints",
        log_every_n_steps: int = 50,
        check_val_every_n_epoch: int = 1,
        callbacks: Optional[List] = None,
        mesh=None,
        seed: int = 42,
        profile_steps: Optional[range] = None,
        profile_dir: str = "profiles",
        ckpt_every_n_steps: Optional[int] = None,
        deterministic_val: bool = False,
        enable_checkpointing: bool = True,
        num_sanity_val_steps: int = 0,
        fused_steps: int = 1,
    ) -> None:
        """The JAX Trainer's arguments. ``num_sanity_val_steps`` defaults to
        0 here, as in JAX; the CLI applies Lightning's 2. ``mesh``: the
        (dp, mp) mesh of ranks the System steps over (see the module
        docstring)."""
        self.system = system
        self.mesh = mesh
        if mesh is not None:
            system.distribute(mesh)
        self.is_main = mesh is None or mesh.rank == 0
        self.datamodule = datamodule
        self.max_epochs = max_epochs or system.config.max_epochs
        self.ckpt_dir = ckpt_dir
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.callbacks = callbacks or []
        self.seed = seed
        self.profile_steps = profile_steps
        self.profile_dir = profile_dir
        self.ckpt_every_n_steps = ckpt_every_n_steps
        self.deterministic_val = deterministic_val
        self.enable_checkpointing = enable_checkpointing
        self.num_sanity_val_steps = int(num_sanity_val_steps)
        self.fused_steps = max(1, int(fused_steps))
        self.history: List[Dict[str, float]] = []
        self._device_lock = threading.Lock()  # the prefetch copies against a capture

    @property
    def device(self) -> torch.device:
        return resolve_device(self.system.device)

    # --------------------------------------------------------------- fit
    def fit(self, resume: Optional[str] = None) -> System:
        system, dm = self.system, self.datamodule
        system.generator = torch.Generator().manual_seed(self.seed)
        start_epoch = self._restore(resume) if resume else 0
        system.check_replicas()

        if self.num_sanity_val_steps:
            self._run_validation(
                system.effect_flags(start_epoch), torch.Generator().manual_seed(self.seed + 2),
                epoch=start_epoch, tag="sanity", limit_batches=self.num_sanity_val_steps,
            )

        best_val = float("inf")
        k = self.fused_steps
        fused: Optional[FusedSteps] = None  # the epoch's flags' steps, built when first seen
        for epoch in range(start_epoch, self.max_epochs):
            flags = system.effect_flags(epoch)
            if k > 1 and (fused is None or fused.flags != flags):
                if fused is not None:
                    fused.release()  # the flags only move forward: its graph is done
                fused = FusedSteps(system, flags, k, capture_lock=self._device_lock)
            t_epoch = time.time()
            n_steps = 0
            logged_blocks = saved_blocks = 0
            metrics = None
            # steps are queued on the card without waiting; the log points
            # synchronize, and steps/s is the wall time over the whole window
            t_sync = time.time()
            steps_since_sync = 0

            tracing = None
            batches = _prefetch(dm.train_dataloader(), self.device, lock=self._device_lock, mesh=self.mesh)
            for i, group in enumerate(self._group_batches(batches)):
                if self.profile_steps and self.is_main and i == self.profile_steps.start:
                    tracing = trace(self.profile_dir)
                    tracing.__enter__()
                if k > 1:
                    graphs = len(fused.captures)
                    metrics = fused(group)[-1]
                    batch = group[-1]
                    if len(fused.captures) > graphs and self.is_main:
                        c = fused.captures[-1]
                        pool = (f"its pool {c['pool_growth'] / 2**30:.2f} GiB" if graphs == 0 else
                                f"the shared pool grew by {c['pool_growth'] / 2**30:.2f} GiB to"
                                f" {fused.pool_bytes / 2**30:.2f} GiB")
                        print(f"fused: {k} steps a CUDA graph replay from epoch {epoch}'s group {i + 2} on for"
                              f" batches of {c['shapes'][0]}, captured in {c['capture_s']:.3f} s, instantiated in"
                              f" {c['instantiate_s']:.3f} s, {pool}", flush=True)
                else:
                    metrics = system.train_step(group, flags)
                    batch = group
                if tracing is not None and i == self.profile_steps.stop:
                    tracing = self._end_trace(tracing, epoch)
                n_steps += k
                steps_since_sync += k
                if n_steps // self.log_every_n_steps > logged_blocks:
                    logged_blocks = n_steps // self.log_every_n_steps
                    host = {name: float(v) for name, v in metrics.items()}  # synchronizes
                    now = time.time()
                    sps = steps_since_sync / max(now - t_sync, 1e-9)
                    t_sync, steps_since_sync = now, 0
                    bs, _, length = batch.tracks.shape
                    bs, _ = system.rows(bs)  # the global batch's
                    host.update(epoch=epoch, steps_per_sec=sps,
                                realtime_factor=sps * bs * length / _SAMPLE_RATE)
                    self.history.append(host)
                    self._log("train", host)
                if (
                    self.enable_checkpointing
                    and self.ckpt_every_n_steps
                    and n_steps // self.ckpt_every_n_steps > saved_blocks
                ):
                    saved_blocks = n_steps // self.ckpt_every_n_steps
                    # a mid-epoch save: a resume restarts this epoch (the
                    # dataloader has no mid-stream state); the optimizer and
                    # the step count carry over exactly
                    self._save("last", next_epoch=epoch)
            if tracing is not None:  # the epoch ended inside the traced steps
                self._end_trace(tracing, epoch)
            if metrics is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_time = time.time() - t_epoch

            val_metrics: Dict[str, float] = {}
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = self._run_validation(flags, _split(system.generator), epoch)

            if self.enable_checkpointing:
                self._save("last", next_epoch=epoch + 1)
                if val_metrics.get("loss", float("inf")) < best_val:
                    best_val = val_metrics["loss"]
                    self._save("best", next_epoch=epoch + 1)

            self._log("epoch", {
                "epoch": epoch,
                "steps": n_steps,
                "epoch_seconds": epoch_time,
                **{f"val/{name}": v for name, v in val_metrics.items()},
            })
        return system

    def _group_batches(self, batches: Iterator[Batch]) -> Iterator[Union[Batch, List[Batch]]]:
        """``fused_steps`` 1: the batches as they come. Otherwise lists of
        K batches; batches left over at the epoch's end raise (JAX's
        ``_group_batches``)."""
        if self.fused_steps == 1:
            yield from batches
            return
        group: List[Batch] = []
        for b in batches:
            group.append(b)
            if len(group) == self.fused_steps:
                yield group
                group = []
        if group:
            raise ValueError(
                f"epoch length not divisible by fused_steps={self.fused_steps}: {len(group)} "
                "batches left over; set steps_per_epoch to a multiple of fused_steps"
            )

    def _end_trace(self, tracing, epoch: int) -> None:
        """End the trace (``utils/profiler.py::trace``): the card
        synchronized, its Chrome trace written into ``profile_dir``."""
        tracing.__exit__(None, None, None)
        r = self.profile_steps
        self.log_line(f"profile: steps {r.start}-{r.stop} of epoch {epoch} traced into {self.profile_dir}")

    # ------------------------------------------------------- checkpoints
    def _meta(self, next_epoch: int) -> Dict:
        return {
            "next_epoch": int(next_epoch),
            "step": int(self.system.step),
            "steps_per_epoch": int(self.system.config.steps_per_epoch),
        }

    def log_line(self, text: str) -> None:
        """Print ``text`` on rank 0."""
        if self.is_main:
            print(text, flush=True)

    def _save(self, name: str, next_epoch: int) -> None:
        """Rank 0 writes the checkpoint (the state is replicated)."""
        if not self.is_main:
            return
        path = os.path.join(self.ckpt_dir, name)
        t0 = time.perf_counter()
        size = save_state(path, self.system, meta=self._meta(next_epoch))
        print(f"checkpoint: saved {path} ({size} bytes) in {time.perf_counter() - t0:.3f} s",
              flush=True)

    def _restore(self, resume: str) -> int:
        """Restore the System from ``resume``; return the epoch to start at:
        the meta's ``next_epoch``, else (no sidecar) one derived from the step."""
        t0 = time.perf_counter()
        restore_state(resume, self.system)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.log_line(f"checkpoint: restored {resume} in {time.perf_counter() - t0:.3f} s")
        meta = load_meta(resume)
        if "next_epoch" in meta:
            return int(meta["next_epoch"])
        return self.system.step // max(1, self.system.config.steps_per_epoch)

    # -------------------------------------------------------- evaluation
    def _run_validation(
        self, flags, generator: torch.Generator, epoch: int,
        dataloader=None, tag: str = "val", limit_batches: Optional[int] = None,
    ) -> Dict[str, float]:
        """One pass over an eval dataloader (val by default), drawing from
        ``generator`` (or by the deterministic rule); logs, and calls the
        callbacks' ``on_validation_end`` except in the sanity check.
        ``limit_batches`` truncates the pass."""
        agg: Dict[str, list] = collections.defaultdict(list)
        outputs = None
        if dataloader is None:
            dataloader = self.datamodule.val_dataloader()
        if limit_batches is not None:
            dataloader = itertools.islice(dataloader, limit_batches)
        for i, batch in enumerate(_prefetch(dataloader, self.device, mesh=self.mesh)):
            gen = (torch.Generator().manual_seed(_fold_in(self.seed + 1, i))
                   if self.deterministic_val else generator)
            with _drawing_from(self.system, gen):
                metrics, outputs = self.system.eval_step(batch, flags)
            for name, v in metrics.items():
                agg[name].append(float(v))
        val_metrics = {name: float(np.mean(v)) for name, v in agg.items()}
        self._log(tag, {**val_metrics, "epoch": epoch})
        if tag != "sanity" and self.is_main:  # Lightning suppresses user hooks during sanity
            for cb in self.callbacks:
                if hasattr(cb, "on_validation_end") and outputs is not None:
                    cb.on_validation_end(epoch, self.system, outputs, val_metrics)
        return val_metrics

    def _eval_pass(self, resume: Optional[str], loader_fn, tag: str) -> Dict[str, float]:
        """Restore ``resume`` (else keep the System's weights) and run one
        pass over ``loader_fn()``, at the flags of the checkpoint's epoch."""
        epoch = self._restore(resume) if resume else 0
        self.system.check_replicas()
        generator = _split(torch.Generator().manual_seed(self.seed))
        return self._run_validation(
            self.system.effect_flags(epoch), generator, epoch, dataloader=loader_fn(), tag=tag
        )

    def validate(self, resume: Optional[str] = None) -> Dict[str, float]:
        """One validation pass (the CLI's ``validate``)."""
        return self._eval_pass(resume, self.datamodule.val_dataloader, "val")

    def test(self, resume: Optional[str] = None) -> Dict[str, float]:
        """One pass over the test split (the CLI's ``test``)."""
        return self._eval_pass(resume, self.datamodule.test_dataloader, "test")

    def _log(self, tag: str, metrics: Dict[str, float]) -> None:
        """Print and hand the metrics to the callbacks, on rank 0 only."""
        if not self.is_main:
            return
        parts = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items()
        )
        print(f"[{tag}] {parts}", flush=True)
        for cb in self.callbacks:
            if hasattr(cb, "on_log"):
                cb.on_log(tag, metrics)
