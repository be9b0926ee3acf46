"""K train steps as one unit: the Trainer's ``fused_steps``.

Port of ``diffmst_tpu/train/trainer.py::_make_fused_step``, which runs K
steps in one device dispatch (``lax.scan`` over K stacked batches). Here, on
the card, one replay of a CUDA graph holds K whole ``System.train_step``
calls (reference render, model, console, loss, backward, clip and Adam); on
the CPU the same staged steps run eagerly. Either way a group's results are
those of K sequential ``train_step`` calls on the same batches:

  * staging: before a group runs, the host takes each inner step's draws
    from ``system.generator`` in a sequential step's order (the naive mix's
    three uniform draws; with the fx bus, the seeds of the reference
    render's and the predicted render's reverb noise, which is then drawn on
    the device from them), and the update scalars (below). The draws and
    the scalars go through a pinned host buffer (two, used in turn, each
    reused only after its copy's event) into static device tensors; the K
    batches are copied into static buffers too;
  * capture: the first group of a batch shape runs eagerly on a side
    stream (real training steps, which also warm up cuDNN, cuBLAS, cuFFT's
    plans, the kernels' libraries and the optimizer's state); the blocks
    it cached go back to the card, then the K steps are captured from the
    static buffers into one graph (its private pool is what one eager step
    reserves: the K steps reuse it), with the prefetch thread held off
    (``capture_lock``), and the blocks the capture freed outside its pool
    go back as well. The host counters that the capture moved are set back;
  * replay: each later group of that shape refills the static buffers and
    replays its graph. The System's ``step`` then advances by K on the
    host, and the kernels' launch counters by what the capture counted
    (``kernels.launch_counts``): a replay launches without the wrappers.

Which inner steps update, and with which scalars:

  * the host decides (``skip_nonfinite_updates`` 0 and an
    ``accumulate_grad_batches`` that divides K): every group starts at the
    same accumulation offset, so the steps that update are fixed. The host
    stages each update's learning rate and OptaxAdam bias corrections from
    the System's counters (``System.update_scalars``), the graph bakes in
    the pattern, and ``updates``, ``_mini_step`` and OptaxAdam's ``count``
    advance on the host as K steps move them. A group that starts at
    another offset than the graph's (an eager step in between) is captured
    as a graph of its own;
  * the device decides (non-finite skipping, or an accumulation that does
    not divide K): whether a step updates depends on its gradients or on
    the group's offset, which moves from group to group. The counters move
    into one tensor on the device (``System.count_on_device``) and each
    step takes ``System._apply_on_device``'s masked update, which keeps the
    old state by a select where it does not update. The scalars are a
    table (``ScalarTable``) of 2K + 1 rows for the counts the group can
    reach, filled by ``System.update_scalars`` and indexed on the device by
    the counters modulo 2K + 1. The host learns the counters one group late
    (a copy after each group, read two groups on, when the card has long
    finished it): they then lie within K updates below the group's start,
    and the group adds at most K. An accumulation that does not divide K
    takes this path too, and not one graph per offset: the offsets cycle
    through up to ``accumulate_grad_batches`` values, and each graph would
    cost a warm-up group, a capture and its share of the pool.

A group of batches whose shapes are new is captured as a graph of its own
(as JAX's jit compiles again), in the first graph's pool: one float32 graph
reserves what one eager step does, and two pools would not fit beside the
eager cache. That is safe while nothing a graph leaves live is another's
input: the static buffers, the counters, the accumulated gradients and the
optimizer's state live outside the pool, and a group's metrics must be read
before another graph replays. A group of mixed shapes raises
``ValueError``, as JAX's ``jnp.stack`` does.

``torch.optim.Adam`` becomes ``capturable`` on the card
(``System.use_capturable_optimizer``). A replay's metrics are tensors of the
graph, which the next replay overwrites. The System's state must be changed
in place only (``load_state_dict`` of ``torch.optim.Adam`` makes new
tensors): a replay whose captured tensors were replaced raises.

Over a mesh (JAX ``trainer.py:297-309``) the staged draws are the global
batch's, as a sequential step's are (``System.draw_ref_params``,
``System.reverb_noise``), and each step takes its rows. On the card the
mesh's collectives (BatchNorm's statistics, the gradients, the metrics, the
track gather) are captured into the graph: NCCL's can be, gloo's cannot,
so a mesh on gloo raises on the card. On the CPU the steps run eagerly.

Refused, as JAX refuses it: a host-side ``mix_fn`` (KE, ``ValueError``).
On CUDA a failed capture or replay raises; the fused path never runs eager
steps in place of a graph but for a shape's first group, which is its
warm-up.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch

from diffmst_torch.kernels import launch_counts, set_launch_counts
from diffmst_torch.ops.reverb import reverb_noise_from_seed, reverb_noise_seed, reverb_noise_shape
from diffmst_torch.train.system import Batch, EffectFlags, OptaxAdam, ScalarTable, System, UpdateScalars
from diffmst_torch.utils.device import resolve_device

__all__ = ["FusedSteps"]


def _shapes(batch: Batch):
    return tuple(tuple(t.shape) for t in (batch.tracks, batch.track_padding, batch.ref_mix))


class _Group:
    """One batch shape's static buffers (K batches, the draws and update
    scalars, the reverb noise), the pinned buffers that stage them, and the
    shape's graph once captured (``FusedSteps._allocate``)."""

    def __init__(self) -> None:
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None


class FusedSteps:
    """``k`` train steps of ``system`` at ``flags`` a call: ``steps(batches)``
    with ``k`` batches of one shape returns the ``k`` steps' metrics.

    ``capture_lock`` (a lock or any context manager) is held while a graph
    is captured; the Trainer's prefetch thread takes it around its copies.
    ``captures`` holds one entry a graph: its batch shapes, the capture's
    and the instantiation's wall seconds, and how far the pool grew
    (``pool_growth``, bytes); ``capture_s``, ``instantiate_s`` are the last
    capture's and ``pool_bytes`` what the shared pool reserved in all.
    ``graph`` is the last group's graph (None before its capture).
    ``release()`` frees every graph and its buffers.
    """

    def __init__(self, system: System, flags: EffectFlags, k: int, capture_lock=None) -> None:
        cfg = system.config
        if cfg.generate_mix and getattr(system.mix_fn, "host_side", False):
            raise ValueError(
                "fused_steps > 1 cannot host a host-side mix_fn (KE): the per-step parameter "
                "sampling runs on the host and a fused group has no per-step host boundary. "
                "Set fused_steps=1 for knowledge_engineering_mix runs."
            )
        self.system, self.flags, self.k = system, flags, int(k)
        # the device decides which steps update (see the module docstring)
        self.on_device = cfg.skip_nonfinite_updates > 0 or self.k % cfg.accumulate_grad_batches != 0
        self.capture_lock = capture_lock if capture_lock is not None else contextlib.nullcontext()
        self.device = resolve_device(system.device)
        self.on_card = self.device.type == "cuda"
        mesh = system.data_mesh
        if self.on_card and mesh is not None and mesh.backend != "nccl":
            raise ValueError(
                f"fused_steps > 1 on the card captures the mesh's collectives into a CUDA graph, which "
                f"NCCL's can join and {mesh.backend}'s cannot: run the ranks on NCCL, or set fused_steps=1"
            )
        self._groups: Dict[tuple, _Group] = {}
        self._last: Optional[_Group] = None
        self._pool = None  # the first graph's private pool, which the others share
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures: List[Dict] = []
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        # the counters after each group, in turn (pinned on the card), with
        # the copy's event and the System's counter writes at that time
        self._seen: List[Optional[tuple]] = [None, None]
        self._seen_host: List[torch.Tensor] = []
        self._turn = 0
        if self.on_card:
            system.use_capturable_optimizer()

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return None if self._last is None else self._last.graph

    # ------------------------------------------------------------ buffers
    def _allocate(self, batch: Batch) -> _Group:
        """Static buffers for K batches of ``batch``'s shapes, the draws
        (``vals``: one row a step) and the scalars (a column each in
        ``vals`` where the host decides; a ``ScalarTable`` of 2K + 1 rows
        after them where the device does), and the reverb noise."""
        system, k, dev = self.system, self.k, self.device
        console = system.mix_console
        g = _Group()
        g.tracks = torch.empty((k, *batch.tracks.shape), dtype=batch.tracks.dtype, device=dev)
        g.padding = torch.empty((k, *batch.track_padding.shape), dtype=batch.track_padding.dtype, device=dev)
        g.ref_mix = torch.empty((k, *batch.ref_mix.shape), dtype=batch.ref_mix.dtype, device=dev)
        bs, n, _ = batch.tracks.shape
        total, _ = system.rows(bs)  # the draws are the global batch's
        draws = system.config.generate_mix
        g.param_shapes = ((total, n, console.num_track_control_params),
                          (total, console.num_fx_bus_control_params),
                          (total, console.num_master_bus_control_params)) if draws else ()
        sizes = [torch.Size(s).numel() for s in g.param_shapes]
        g.n_draws = sum(sizes)
        width = g.n_draws + (0 if self.on_device else 3)  # the draws, then lr, bc1, bc2
        g.rows = 2 * k + 1 if self.on_device else 0
        flat = torch.empty(k * width + 3 * g.rows, dtype=torch.float32, device=dev)
        g.vals = flat[:k * width].view(k, width)
        g.flat = flat
        g.tensor_scalars = self.on_card or isinstance(system.optimizer, OptaxAdam)
        # one host buffer on the CPU (it is the static one); two pinned ones,
        # used in turn, on the card
        g.host = ([torch.empty(flat.shape, dtype=torch.float32, pin_memory=True) for _ in range(2)]
                  if self.on_card else [flat])
        g.copied = [None] * len(g.host)
        g.slot = 0

        g.noise = None
        if self.flags.use_fx_bus:
            g.noise_shape = reverb_noise_shape(total, 2, console.reverb_num_samples, console.reverb_num_taps)
            g.noise = torch.empty((k, 2, *g.noise_shape), dtype=batch.tracks.dtype, device=dev)

        host_ids = batch.instrument_id.cpu(), batch.stereo_info.cpu()  # read only by KE, refused
        table = None
        if self.on_device:
            table = ScalarTable(*flat[k * width:].view(3, g.rows).unbind(),
                                torch.empty((), dtype=torch.float32, device=dev))
        g.batches, g.ref_params, g.reverb, g.scalars = [], [], [], []
        for j in range(k):
            g.batches.append(Batch(g.tracks[j], host_ids[0], host_ids[1], g.padding[j], g.ref_mix[j]))
            params = None
            if draws:
                params = tuple(v.view(s) for v, s in zip(g.vals[j, :g.n_draws].split(sizes), g.param_shapes))
            g.ref_params.append(params)
            g.reverb.append(None if g.noise is None else (g.noise[j, 0], g.noise[j, 1]))
            # the steps read the scalars from the static tensor, but for
            # torch.optim.Adam on the CPU where the host decides: its
            # non-capturable update takes the host's float learning rate
            if table is not None:
                g.scalars.append(table)
            else:
                g.scalars.append(UpdateScalars(*g.vals[j, -3:].unbind()) if g.tensor_scalars else None)
        return g

    # ------------------------------------------------------------ staging
    def _stage(self, g: _Group, batches: Sequence[Batch]) -> None:
        """Draw the group's inputs on the host in a sequential run's order
        and put them, with the batches and the update scalars, into the
        static buffers."""
        system, k = self.system, self.k
        slot = g.slot
        host = g.host[slot]
        width = g.vals.shape[1]
        if g.copied[slot] is not None:
            g.copied[slot].synchronize()  # its last copy to the card has finished
        gen = system.generator
        seeds = []
        for j in range(k):
            if g.param_shapes:
                draws = system.draw_ref_params(g.tracks[j], device="cpu")
                torch.cat([d.reshape(-1) for d in draws], out=host[j * width:j * width + g.n_draws])
            if g.noise is not None:
                # the reference render's noise, then the predicted render's
                seeds.append((j, 0, reverb_noise_seed(gen)) if g.param_shapes else None)
                seeds.append((j, 1, reverb_noise_seed(gen)))
        scalars = None
        if self.on_device:
            host[k * width:] = self._table(g.rows).reshape(-1)
        else:
            scalars = self._schedule()
            host[:k * width].view(k, width)[:, -3:] = torch.tensor([[float(v) for v in s] for s in scalars],
                                                                   dtype=torch.float32)
        if self.on_card:
            g.flat.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            g.copied[slot] = event
            g.slot = (slot + 1) % len(g.host)
        if not g.tensor_scalars and scalars is not None:
            g.scalars = scalars
        for j, b in enumerate(batches):
            g.tracks[j].copy_(b.tracks, non_blocking=True)
            g.padding[j].copy_(b.track_padding, non_blocking=True)
            g.ref_mix[j].copy_(b.ref_mix, non_blocking=True)
        for s in seeds:
            if s is not None:
                j, which, seed = s
                g.noise[j, which].copy_(reverb_noise_from_seed(seed, g.noise_shape, self.device, g.noise.dtype))

    def _schedule(self) -> List[UpdateScalars]:
        """Where the host decides: each inner step's update scalars, from
        the counters as K sequential steps would move them (an inner step
        that only accumulates updates nothing; its row is not read)."""
        system = self.system
        a = system.config.accumulate_grad_batches
        updates, mini = system.updates, system._mini_step
        count = self.system.optimizer.count if isinstance(system.optimizer, OptaxAdam) else 0
        out = []
        for _ in range(self.k):
            mini = (mini + 1) % a
            if mini:
                out.append(UpdateScalars(0.0, 1.0, 1.0))
                continue
            count += 1
            out.append(system.update_scalars(updates, count))
            updates += 1
        return out

    def _table(self, rows: int) -> torch.Tensor:
        """Where the device decides: the (3, rows) ``ScalarTable`` of the
        group about to run, for the ``rows`` update and OptaxAdam counts
        from those the host last learned (``_known``)."""
        system = self.system
        updates, count = self._known()
        table = torch.empty((3, rows), dtype=torch.float32)
        for i in range(rows):
            s = system.update_scalars(updates + i, count + i + 1)
            table[0, (updates + i) % rows] = float(s.lr)
            table[1:, (count + i) % rows] = torch.tensor([float(s.bc1), float(s.bc2)])
        return table

    def _writes(self) -> int:
        return self.system.counter_writes + getattr(self.system.optimizer, "counter_writes", 0)

    def _known(self):
        """(updates, OptaxAdam's count) at most one group's updates below
        where the group about to run starts: the counters copied after the
        group before last, whose copy the card has finished by now (the host
        never waits for the group it just queued), or, where there is none
        or the host wrote the counters since, the counters themselves."""
        seen = self._seen[self._turn]
        if seen is not None and seen[1] == self._writes():
            if seen[0] is not None:
                seen[0].synchronize()
            values = self._seen_host[self._turn].tolist()
        else:
            values = self.system.counters.tolist()  # synchronizes
        return values[0], values[3]

    def _note_counters(self) -> None:
        """Copy the counters after a group, for the group after next."""
        turn = self._turn
        if not self._seen_host:
            self._seen_host = [torch.empty(4, dtype=torch.int64, pin_memory=self.on_card) for _ in range(2)]
        self._seen_host[turn].copy_(self.system.counters, non_blocking=self.on_card)
        event = None
        if self.on_card:
            event = torch.cuda.Event()
            event.record()
        self._seen[turn] = (event, self._writes())
        self._turn = 1 - turn

    # ------------------------------------------------------------ running
    def _program(self, g: _Group) -> List[Dict[str, torch.Tensor]]:
        """The K steps on the static buffers: what the graph holds."""
        system = self.system
        return [system.train_step(g.batches[j], self.flags, g.ref_params[j], g.reverb[j], g.scalars[j])
                for j in range(self.k)]

    def _host_counters(self) -> Dict[str, int]:
        system = self.system
        out = {"step": system.step}
        if not self.on_device:
            out.update(updates=system.updates, mini_step=system._mini_step)
            if isinstance(system.optimizer, OptaxAdam):
                out["count"] = system.optimizer.count
        return out

    def _set_host_counters(self, counters: Dict[str, int]) -> None:
        system = self.system
        system.step = counters["step"]
        if "updates" in counters:
            system.updates, system._mini_step = counters["updates"], counters["mini_step"]
        if "count" in counters:
            system.optimizer.count = counters["count"]

    def _state_tensors(self) -> List[torch.Tensor]:
        """The tensors a replay reads and writes in place: parameters,
        buffers, optimizer state, the accumulated gradients, the counters
        where the device decides."""
        system = self.system
        out = list(system.params) + list(system.model.buffers())
        opt = system.optimizer
        if isinstance(opt, OptaxAdam):
            out += opt.mu + opt.nu
        else:
            out += [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
        out += list(system._acc or [])
        return out + ([system.counters] if self.on_device else [])

    def _capture(self, g: _Group, shapes) -> None:
        """Capture ``_program`` into one graph on the side stream, in the
        shared pool, the prefetch thread held off; set back what the
        capture moved on the host."""
        counters, counts = self._host_counters(), launch_counts()
        # the warm-up's cached blocks go back to the card (``torch.cuda.graph``
        # does so too), so that what the capture reserves is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with self.capture_lock:
                t0 = time.perf_counter()
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                    outputs = self._program(g)
                capture_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            graph.instantiate()
            instantiate_s = time.perf_counter() - t0
            growth = torch.cuda.memory_reserved(self.device) - reserved
            # the blocks the capture freed outside its pool (the warm-up's
            # gradients) go back too
            torch.cuda.empty_cache()
        except BaseException:
            self._set_host_counters(counters)  # no step was taken
            set_launch_counts(counts)
            raise
        after_counters, after_counts = self._host_counters(), launch_counts()
        g.counter_delta = {k: after_counters[k] - v for k, v in counters.items()}
        g.count_delta = {k: after_counts[k] - v for k, v in counts.items()}
        self._set_host_counters(counters)
        set_launch_counts(counts)
        if self._pool is None:
            self._pool = graph.pool()
        g.graph, g.outputs = graph, outputs
        g.captured = [t.data_ptr() for t in self._state_tensors()]
        self.capture_s, self.instantiate_s = capture_s, instantiate_s
        self.pool_bytes += growth
        self.captures.append(dict(shapes=shapes, capture_s=capture_s, instantiate_s=instantiate_s,
                                  pool_growth=growth))

    def release(self) -> None:
        """Free every graph, their pool (the gradients a graph left in
        ``.grad`` live there) and the static buffers, and hand the card's
        cached blocks back (the Trainer calls it when the epoch's flags move
        on: they never come back)."""
        graphs = [g.graph for g in self._groups.values() if g.graph is not None]
        self._groups, self._last, self._pool = {}, None, None  # the buffers, and the outputs in the pool
        for graph in graphs:
            graph.reset()
        if graphs:
            for p in self.system.params:
                p.grad = None
        if self.on_card:
            torch.cuda.empty_cache()

    def _replay(self, g: _Group) -> List[Dict[str, torch.Tensor]]:
        if [t.data_ptr() for t in self._state_tensors()] != g.captured:
            raise RuntimeError(
                "the System's parameters, buffers or optimizer state were replaced since the fused "
                "steps were captured (restore state in place, or build a new FusedSteps)"
            )
        g.graph.replay()
        self._set_host_counters({k: v + g.counter_delta[k] for k, v in self._host_counters().items()})
        set_launch_counts({k: v + g.count_delta[k] for k, v in launch_counts().items()})
        return g.outputs

    def __call__(self, batches: Sequence[Batch]) -> List[Dict[str, torch.Tensor]]:
        if len(batches) != self.k:
            raise ValueError(f"fused_steps={self.k} takes {self.k} batches a call, got {len(batches)}")
        shapes = _shapes(batches[0])
        for b in batches[1:]:
            if _shapes(b) != shapes:
                raise ValueError(f"fused_steps: a batch of shapes {_shapes(b)} in a group of {shapes}")
        system = self.system
        if self.on_device:
            system.count_on_device()
            key = shapes
        else:  # the graph bakes in which steps update: the group's offset
            key = (shapes, system._mini_step)
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = self._allocate(batches[0])
        self._last = g
        self._stage(g, batches)
        if not self.on_card:
            out = self._program(g)
        elif g.graph is not None:
            out = self._replay(g)
        else:
            # the shape's first group: its steps run eagerly on the capture
            # stream (they warm it up), then the graph is captured
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                out = self._program(g)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self._capture(g, shapes)
        if self.on_device:
            self._note_counters()
        return out
