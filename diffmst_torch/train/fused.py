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
    the device from them), and each update's learning rate and OptaxAdam
    bias corrections from the System's counters (``System.update_scalars``).
    The draws and the scalars go through a pinned host buffer (two, used in
    turn, each reused only after its copy's event) into static device
    tensors; the K batches are copied into static buffers too;
  * capture: the first group of an ``EffectFlags`` runs eagerly on a side
    stream (real training steps, which also warm up cuDNN, cuBLAS, cuFFT's
    plans, the kernels' libraries and the optimizer's state); the blocks
    it cached go back to the card, then the K steps are captured from the
    static buffers into one graph (its private pool is what one eager step
    reserves: the K steps reuse it), with the prefetch thread held off
    (``capture_lock``), and the blocks the capture freed outside its pool
    go back as well. The host counters that the capture moved are set back;
  * replay: each later group refills the static buffers and replays the
    graph. The System's ``step`` and ``updates`` and OptaxAdam's ``count``
    then advance as K steps advance them, and the kernels' launch counters
    by what the capture counted (``kernels.launch_counts``): a replay
    launches without the wrappers.

``torch.optim.Adam`` becomes ``capturable`` on the card
(``System.use_capturable_optimizer``). A replay's metrics are tensors of the
graph, which the next replay overwrites. The System's state must be changed
in place only (``load_state_dict`` of ``torch.optim.Adam`` makes new
tensors): a replay whose captured tensors were replaced raises.

Refused: a host-side ``mix_fn`` (KE), as JAX refuses it (``ValueError``);
``skip_nonfinite_updates`` > 0 (its check reads the gradients on the host),
an ``accumulate_grad_batches`` that does not divide K, and a group that
starts inside an accumulation (``NotImplementedError``, ROADMAP Queue 1,
item 12d). On CUDA a failed capture or replay raises; the fused path never
runs eager steps in place of the graph but for the first group's, which
are its warm-up.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import torch

from diffmst_torch.kernels import launch_counts, set_launch_counts
from diffmst_torch.mixing.naive import draw_mix_params
from diffmst_torch.ops.reverb import reverb_noise_from_seed, reverb_noise_seed, reverb_noise_shape
from diffmst_torch.train.system import Batch, EffectFlags, OptaxAdam, System, UpdateScalars
from diffmst_torch.utils.device import resolve_device

__all__ = ["FusedSteps"]


class FusedSteps:
    """``k`` train steps of ``system`` at ``flags`` a call: ``steps(batches)``
    with ``k`` batches of one shape returns the ``k`` steps' metrics.

    ``capture_lock`` (a lock or any context manager) is held while the graph
    is captured; the Trainer's prefetch thread takes it around its copies.
    ``capture_s`` and ``instantiate_s`` are the capture's and the graph's
    instantiation's wall seconds, and ``pool_bytes`` the card memory the
    graph's private pool reserved, once captured. ``release()`` frees the
    graph and its buffers.
    """

    def __init__(self, system: System, flags: EffectFlags, k: int, capture_lock=None) -> None:
        cfg = system.config
        if cfg.generate_mix and getattr(system.mix_fn, "host_side", False):
            raise ValueError(
                "fused_steps > 1 cannot host a host-side mix_fn (KE): the per-step parameter "
                "sampling runs on the host and a fused group has no per-step host boundary. "
                "Set fused_steps=1 for knowledge_engineering_mix runs."
            )
        if cfg.skip_nonfinite_updates > 0:
            raise NotImplementedError(
                "fused_steps > 1 with skip_nonfinite_updates > 0 is not ported to diffmst_torch "
                "yet: the finiteness check reads the gradients on the host (ROADMAP Queue 1, item 12d)"
            )
        if k % cfg.accumulate_grad_batches:
            raise NotImplementedError(
                f"fused_steps={k} must be a multiple of accumulate_grad_batches="
                f"{cfg.accumulate_grad_batches} in diffmst_torch (ROADMAP Queue 1, item 12d)"
            )
        self.system, self.flags, self.k = system, flags, int(k)
        self.capture_lock = capture_lock if capture_lock is not None else contextlib.nullcontext()
        self.device = resolve_device(system.device)
        self.on_card = self.device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        self._shapes = None
        if self.on_card:
            system.use_capturable_optimizer()

    # ------------------------------------------------------------ buffers
    def _allocate(self, batch: Batch) -> None:
        """Static buffers for K batches of ``batch``'s shapes, the draws and
        the scalars (``_vals``: one row a step), and the reverb noise."""
        system, k, dev = self.system, self.k, self.device
        console = system.mix_console
        self._shapes = tuple(tuple(t.shape) for t in (batch.tracks, batch.track_padding, batch.ref_mix))
        self._tracks = torch.empty((k, *batch.tracks.shape), dtype=batch.tracks.dtype, device=dev)
        self._padding = torch.empty((k, *batch.track_padding.shape), dtype=batch.track_padding.dtype,
                                    device=dev)
        self._ref_mix = torch.empty((k, *batch.ref_mix.shape), dtype=batch.ref_mix.dtype, device=dev)
        bs, n, _ = batch.tracks.shape
        draws = system.config.generate_mix
        self._param_shapes = ((bs, n, console.num_track_control_params),
                              (bs, console.num_fx_bus_control_params),
                              (bs, console.num_master_bus_control_params)) if draws else ()
        sizes = [torch.Size(s).numel() for s in self._param_shapes]
        width = sum(sizes) + 3  # the draws, then lr, bc1, bc2
        self._vals = torch.empty((k, width), dtype=torch.float32, device=dev)
        self._tensor_scalars = self.on_card or isinstance(system.optimizer, OptaxAdam)
        # one host buffer on the CPU (it is the static one); two pinned ones,
        # used in turn, on the card
        self._host = ([torch.empty((k, width), dtype=torch.float32, pin_memory=True) for _ in range(2)]
                      if self.on_card else [self._vals])
        self._copied: List[Optional[torch.cuda.Event]] = [None] * len(self._host)
        self._slot = 0

        self._noise = None
        if self.flags.use_fx_bus:
            shape = reverb_noise_shape(bs, 2, console.reverb_num_samples, console.reverb_num_taps)
            self._noise_shape = shape
            self._noise = torch.empty((k, 2, *shape), dtype=batch.tracks.dtype, device=dev)

        host_ids = batch.instrument_id.cpu(), batch.stereo_info.cpu()  # read only by KE, refused
        self._batches, self._ref_params, self._reverb, self._scalars = [], [], [], []
        for j in range(k):
            self._batches.append(Batch(self._tracks[j], host_ids[0], host_ids[1], self._padding[j],
                                       self._ref_mix[j]))
            params = None
            if draws:
                params = tuple(v.view(s) for v, s in zip(self._vals[j, :-3].split(sizes), self._param_shapes))
            self._ref_params.append(params)
            self._reverb.append(None if self._noise is None else (self._noise[j, 0], self._noise[j, 1]))
            # the steps read the scalars from the static tensor, but for
            # torch.optim.Adam on the CPU: its non-capturable update takes
            # the host's float learning rate
            self._scalars.append(UpdateScalars(*self._vals[j, -3:].unbind()) if self._tensor_scalars else None)

    # ------------------------------------------------------------ staging
    def _stage(self, batches: Sequence[Batch]) -> None:
        """Draw the group's inputs on the host in a sequential run's order
        and put them, with the batches, into the static buffers."""
        system, k = self.system, self.k
        if system._mini_step:
            raise NotImplementedError(
                "a fused group must start at an accumulation boundary (the System is "
                f"{system._mini_step} steps into accumulate_grad_batches="
                f"{system.config.accumulate_grad_batches}; ROADMAP Queue 1, item 12d)"
            )
        slot = self._slot
        host = self._host[slot]
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy to the card has finished
        gen = system.generator
        seeds = []
        for j in range(k):
            if self._param_shapes:
                draws = draw_mix_params(self._tracks[j], system.mix_console, gen, device="cpu")
                torch.cat([d.reshape(-1) for d in draws], out=host[j, :-3])
            if self._noise is not None:
                # the reference render's noise, then the predicted render's
                seeds.append((j, 0, reverb_noise_seed(gen)) if self._param_shapes else None)
                seeds.append((j, 1, reverb_noise_seed(gen)))
        scalars = self._schedule()
        host[:, -3:] = torch.tensor([[float(v) for v in s] for s in scalars], dtype=torch.float32)
        if self.on_card:
            self._vals.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._copied[slot] = event
            self._slot = (slot + 1) % len(self._host)
        if not self._tensor_scalars:
            self._scalars = scalars
        for j, b in enumerate(batches):
            self._tracks[j].copy_(b.tracks, non_blocking=True)
            self._padding[j].copy_(b.track_padding, non_blocking=True)
            self._ref_mix[j].copy_(b.ref_mix, non_blocking=True)
        for s in seeds:
            if s is not None:
                j, which, seed = s
                self._noise[j, which].copy_(reverb_noise_from_seed(seed, self._noise_shape, self.device,
                                                                   self._noise.dtype))

    def _schedule(self) -> List[UpdateScalars]:
        """Each inner step's update scalars, from the counters as K
        sequential steps would move them (an inner step that only
        accumulates updates nothing; its row is not read)."""
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

    # ------------------------------------------------------------ running
    def _program(self) -> List[Dict[str, torch.Tensor]]:
        """The K steps on the static buffers: what the graph holds."""
        system = self.system
        return [system.train_step(self._batches[j], self.flags, self._ref_params[j], self._reverb[j],
                                  self._scalars[j]) for j in range(self.k)]

    def _host_counters(self) -> Dict[str, int]:
        system = self.system
        out = {"step": system.step, "updates": system.updates, "mini_step": system._mini_step}
        if isinstance(system.optimizer, OptaxAdam):
            out["count"] = system.optimizer.count
        return out

    def _set_host_counters(self, counters: Dict[str, int]) -> None:
        system = self.system
        system.step, system.updates, system._mini_step = (counters["step"], counters["updates"],
                                                          counters["mini_step"])
        if "count" in counters:
            system.optimizer.count = counters["count"]

    def _state_tensors(self) -> List[torch.Tensor]:
        """The tensors a replay reads and writes in place: parameters,
        buffers, optimizer state, the accumulated gradients."""
        system = self.system
        out = list(system.params) + list(system.model.buffers())
        opt = system.optimizer
        if isinstance(opt, OptaxAdam):
            out += opt.mu + opt.nu
        else:
            out += [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
        return out + list(system._acc or [])

    def _capture(self) -> None:
        """Capture ``_program`` into one graph on a side stream, the
        prefetch thread held off; set back what the capture moved on the
        host."""
        counters, counts = self._host_counters(), launch_counts()
        # the warm-up's cached blocks go back to the card (``torch.cuda.graph``
        # does so too), so that what the capture reserves is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with self.capture_lock:
                t0 = time.perf_counter()
                with torch.cuda.graph(graph, stream=self._stream):
                    outputs = self._program()
                self.capture_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            # the blocks the capture freed outside its pool (the warm-up's
            # gradients) go back too
            torch.cuda.empty_cache()
        except BaseException:
            self._set_host_counters(counters)  # no step was taken
            set_launch_counts(counts)
            raise
        after_counters, after_counts = self._host_counters(), launch_counts()
        self._counter_delta = {k: after_counters[k] - v for k, v in counters.items()}
        self._count_delta = {k: after_counts[k] - v for k, v in counts.items()}
        self._set_host_counters(counters)
        set_launch_counts(counts)
        self.graph, self._outputs = graph, outputs
        self._captured = [t.data_ptr() for t in self._state_tensors()]

    def release(self) -> None:
        """Free the graph, its private pool (the gradients the graph left in
        ``.grad`` live there) and the static buffers, and hand the card's
        cached blocks back (the Trainer calls it when the epoch's flags move
        on: they never come back)."""
        if self.graph is not None:
            self.graph.reset()
            for p in self.system.params:
                p.grad = None
        self.graph = self._outputs = None
        self._shapes = None
        self._tracks = self._padding = self._ref_mix = self._vals = self._noise = None
        self._host, self._batches, self._ref_params, self._reverb, self._scalars = [], [], [], [], []
        if self.on_card:
            torch.cuda.empty_cache()

    def _replay(self) -> List[Dict[str, torch.Tensor]]:
        if [t.data_ptr() for t in self._state_tensors()] != self._captured:
            raise RuntimeError(
                "the System's parameters, buffers or optimizer state were replaced since the fused "
                "steps were captured (restore state in place, or build a new FusedSteps)"
            )
        self.graph.replay()
        self._set_host_counters({k: v + self._counter_delta[k] for k, v in self._host_counters().items()})
        set_launch_counts({k: v + self._count_delta[k] for k, v in launch_counts().items()})
        return self._outputs

    def __call__(self, batches: Sequence[Batch]) -> List[Dict[str, torch.Tensor]]:
        if len(batches) != self.k:
            raise ValueError(f"fused_steps={self.k} takes {self.k} batches a call, got {len(batches)}")
        if self._shapes is None:
            self._allocate(batches[0])
        for b in batches:
            shapes = tuple(tuple(t.shape) for t in (b.tracks, b.track_padding, b.ref_mix))
            if shapes != self._shapes:
                raise ValueError(f"fused_steps: a batch of shapes {shapes}, the group's are {self._shapes}")
        self._stage(batches)
        if not self.on_card:
            return self._program()
        if self.graph is not None:
            return self._replay()
        # the first group: its steps run eagerly on the capture stream
        # (they warm it up), then the graph is captured
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            metrics = self._program()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self._capture()
        return metrics
