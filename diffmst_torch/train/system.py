"""Training system: the Method-1 / Method-2 train step.

Port of ``diffmst_tpu/train/system.py``. One step, as ``System._common``
(system.py:357-505) takes it:

  draw uniform console parameters and render the reference mix without
  gradients (no input or output fader) -> peak-normalize -> split the mix
  and the tracks at the middle -> the model sees (tracks_b, ref_mix_a),
  Cnn14's BatchNorm in training mode -> the console renders tracks_b with
  the predicted parameters, with gradients -> MRSTFT loss against ref_mix_b
  -> clip the gradients at global norm 10 -> Adam.

Method 2 (``generate_mix=False``) feeds the batch's real reference mix to
both the model and the loss. The loss is a scalar (MRSTFT) or a dict of
named terms (``AudioFeatureLoss``), which the step sums.

A host-side ``mix_fn`` (``knowledge_engineering_mix``, whose ``host_side``
flag is set) has its parameters sampled on the host each step
(``_host_sample_ke``, from the batch's instrument ids and stereo flags as
they came from the host) and rendered on the device without gradients,
as JAX's System does.

JAX's jitted pure step becomes a stateful object: the model holds the
parameters and the BatchNorm statistics, the ``torch.optim.Adam`` its
moments, and ``train_step`` updates them in place. Randomness comes from an
explicit ``torch.Generator`` (``self.generator``), drawn in this order in a
step: the reference mix's parameters (naive: three uniform draws; KE: one
31-bit seed for NumPy), the reference render's reverb noise, the predicted
render's reverb noise (each noise only with the fx bus on; one 63-bit seed
each, ``ops.reverb.draw_reverb_noise``). A caller can instead pass the
reference-mix parameters (``ref_params``), as JAX's System takes
``ke_params``, and the two renders' reverb noise (``reverb_noise``), which
is how the tests feed the port JAX's draws.

The optimizer is ``torch.optim.Adam`` after the clip, or, with either of
the JAX package's optimizer options, ``OptaxAdam``, which takes optax's
steps in optax's order (``diffmst_tpu/train/system.py:198-228``):
``adam_mu_dtype`` stores Adam's first moment in that dtype (bf16 in
``configs/models/naive+tpu.yaml``), and ``flatten_optimizer`` runs the clip
and Adam over one ravelled gradient vector (``optax.flatten``). The two
layouts' checkpoints are not interchangeable: ``load_state_dict`` refuses
the other one.

An update's learning rate and OptaxAdam's bias corrections come from the
host's counters, or from ``UpdateScalars`` (device tensors under a CUDA
graph, which each replay refills: ``train/fused.py``, the Trainer's
``fused_steps``). Where the device decides which steps update (non-finite
skipping or an accumulation that a fused group does not divide), the
optimizer's counters move into one tensor on the device
(``count_on_device``), the step takes its scalars from a ``ScalarTable``
indexed by them, and ``apply_gradients`` selects the updated state with
``torch.where`` (``_apply_on_device``): bitwise what the host's decisions
give.

Over a device mesh (``diffmst_torch/parallel``; JAX ``system.py:141-195,
:268-354``) each rank steps its share of the global batch: its dp row's
rows (``parallel.shard_batch``), and with ``System(mesh=)`` of mp > 1 its
tracks in the track encoder and the console's chain. The mesh is the
System's own (``mesh``) or the Trainer's (``distribute``, which leaves the
track axis alone, as JAX's CLI does). Every rank keeps the same
``generator`` and draws the global batch's reference-mix parameters and
reverb seeds, then takes its rows; parameters a caller passes
(``ref_params``, ``reverb_noise``) are the global batch's too, and so are
the batch's host-side ``instrument_id`` and ``stereo_info``. Before the
clip, the gradients are summed over the ranks: the mean over dp, the
track encoder's partial gradients summed over mp, the rest (whole on every
mp rank) counted once. So the norm, the clip, the non-finite check and Adam
see the global gradients on every rank and take the same step. The metrics
are the global batch's: the mean over dp of the loss terms, the sum of the
non-finite counts. ``check_replicas`` holds the parameters and BatchNorm
statistics to rank 0's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import yaml
from torch.profiler import record_function

from diffmst_torch.mixing import naive_random_mix
from diffmst_torch.mixing.knowledge import REPO_ROOT, instrument_metadata, sample_ke_params
from diffmst_torch.mixing.naive import draw_mix_params
from diffmst_torch.ops.reverb import reverb_noise_from_seed, reverb_noise_seed, reverb_noise_shape
from diffmst_torch.parallel.mesh import (assert_mesh_divisible, batch_rows, bound, check_replicas,
                                         gather_tracks, track_slice)
from diffmst_torch.utils.audio import batch_stereo_peak_normalize
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["SystemConfig", "EffectFlags", "Batch", "System", "UpdateScalars", "ScalarTable", "lr_schedule"]

_ADAM_EPS = 1e-8  # optax.adam's and torch.optim.Adam's default


def _repo_path(path: str) -> str:
    """A relative default path (``data/...``) against the repository root
    when it does not exist from the working directory."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(REPO_ROOT, path)


class Batch(NamedTuple):
    """One training batch (the dataset item, diffmst_tpu system.py:70)."""

    tracks: torch.Tensor  # (bs, max_tracks, seq_len) mono stems
    instrument_id: torch.Tensor  # (bs, max_tracks) int
    stereo_info: torch.Tensor  # (bs, max_tracks) int
    track_padding: torch.Tensor  # (bs, max_tracks) bool, True = padded
    ref_mix: torch.Tensor  # (bs, 2, seq_len) real reference (Method 2)


class UpdateScalars(NamedTuple):
    """What an optimizer update takes from the host's counters: the
    learning rate and OptaxAdam's bias corrections 1 - b1^t, 1 - b2^t (in
    float32, as optax takes them). Floats, or 0-dim float32 tensors on the
    parameters' device that a CUDA graph reads at each replay."""

    lr: Union[float, torch.Tensor]
    bc1: Union[float, torch.Tensor]
    bc2: Union[float, torch.Tensor]


class ScalarTable(NamedTuple):
    """The update scalars of a fused group whose updates the device decides
    (``System.count_on_device``): float32 tensors of ``rows`` on the
    parameters' device, whose row ``u % rows`` holds the learning rate after
    ``u`` updates (``lr``) and row ``c % rows`` OptaxAdam's corrections of
    its update at count ``c`` (``bc1``, ``bc2``), for the ``rows``
    consecutive counts the group can reach. ``lr_now`` (0-dim) receives the
    step's learning rate: ``torch.optim.Adam`` keeps it in its groups, so it
    must not live in a CUDA graph's pool, which ``release`` frees."""

    lr: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    lr_now: torch.Tensor


class _Counter:
    """An optimizer counter of its owner (``System``, ``OptaxAdam``): a host
    int, or, once the owner's ``counters`` tensor holds it (element
    ``index``, ``System.count_on_device``), that element, which a read
    copies to the host (it synchronizes) and a write fills in place; each
    such write adds one to the owner's ``counter_writes``."""

    def __init__(self, index: int) -> None:
        self.index = index

    def __set_name__(self, owner, name: str) -> None:
        self.attr = f"_host_{name.strip('_')}"

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        if obj.counters is not None:
            return int(obj.counters[self.index])
        return getattr(obj, self.attr)

    def __set__(self, obj, value) -> None:
        setattr(obj, self.attr, int(value))
        if obj.counters is not None:
            obj.counters[self.index].fill_(int(value))
            obj.counter_writes += 1


class EffectFlags(NamedTuple):
    """Console toggles for one curriculum stage."""

    use_track_eq: bool = True
    use_track_compressor: bool = True
    use_fx_bus: bool = False
    use_master_bus: bool = True


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """The JAX SystemConfig's fields (system.py:90), with its defaults."""

    generate_mix: bool = True
    use_mix_loss: bool = True
    use_param_loss: bool = False
    active_eq_epoch: int = 0
    active_compressor_epoch: int = 0
    active_fx_bus_epoch: int = 1000  # fx bus disabled in all shipped configs
    active_master_bus_epoch: int = 0
    lr: float = 1e-5
    max_epochs: int = 800
    steps_per_epoch: int = 5000  # 20k examples / batch 4
    schedule: str = "step"  # "step" (x0.1 at 0.85 and 0.95 of the steps) | "cosine" | "none"
    grad_clip: float = 10.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # Gradients average over this many steps before one optimizer update
    # (optax.MultiSteps); the steps between update nothing.
    accumulate_grad_batches: int = 1
    # When > 0, an update whose gradients are not all finite is dropped, up
    # to this many in a row (optax.apply_if_finite); 0 applies every update.
    skip_nonfinite_updates: int = 0
    # dtype of Adam's first moment (optax's ``mu_dtype``; None: the
    # parameters'); the second moment and the parameters keep theirs.
    adam_mu_dtype: Optional[str] = None
    # The clip and Adam over one ravelled gradient vector (optax.flatten):
    # one flat first and second moment; its checkpoints are not
    # interchangeable with the per-leaf layout's.
    flatten_optimizer: bool = False


def lr_schedule(config: SystemConfig) -> Callable[[int], float]:
    """The learning rate after ``count`` optimizer updates (optax's schedules)."""
    total = config.max_epochs * config.steps_per_epoch
    if config.schedule == "step":
        # optax.piecewise_constant_schedule: scaled from count >= boundary on
        bounds = (int(total * 0.85), int(total * 0.95))
        return lambda count: config.lr * 0.1 ** sum(count >= b for b in bounds)
    if config.schedule == "cosine":
        return lambda count: config.lr * 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))
    if config.schedule == "none":
        return lambda count: config.lr
    raise ValueError(f"unknown schedule {config.schedule!r}")


class System:
    """Model + console + mix_fn + loss, trained one step at a time in place.

    ``model`` is a ``MixStyleTransferModel`` on ``device`` (None: the CUDA
    device) and ``mix_console`` a console on the same device; ``generator``
    draws the reference mixes (default: a CPU generator seeded 0).
    ``mesh``: a (dp, mp) mesh (``parallel.make_mesh``) whose ranks step the
    global batch together; with mp > 1 the track axis is split over mp,
    which needs the model built with ``bn_axis_name=("dp", "mp")`` and the
    console with the same mesh (see the module docstring).
    """

    # the optimizer's counters (``_Counter``): updates applied (the
    # schedule's count), the accumulation's mini-step, non-finite gradients
    # in a row; the fourth element of ``counters`` is OptaxAdam's count
    updates = _Counter(0)
    _mini_step = _Counter(1)
    notfinite_count = _Counter(2)

    def __init__(
        self,
        model: torch.nn.Module,
        mix_console,
        loss,
        config: Optional[SystemConfig] = None,
        mix_fn: Callable = naive_random_mix,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
        mesh=None,
        **kwargs,
    ):
        """Extra keyword arguments take the reference's flat names
        (``generate_mix``, ``active_eq_epoch``, ``lr``, ``max_epochs``,
        ``steps_per_epoch``, ...) and override those fields of ``config``, so
        that the shipped YAML configs build this class; unknown keys are
        ignored, as in the JAX System (diffmst_tpu/train/system.py:141-170).
        With a host-side ``mix_fn`` (KE) it loads the instrument lookup
        (``instrument_id_json``, default ``data/instrument_name2id.json``)
        and the KE ranges (``knowledge_engineering_yaml``, default
        ``data/knowledge_engineering.yaml``)."""
        base = dataclasses.asdict(config) if config is not None else {}
        names = {f.name for f in dataclasses.fields(SystemConfig)}
        base.update({k: v for k, v in kwargs.items() if k in names})
        self.config = SystemConfig(**base)
        self.model = model
        self.mix_console = mix_console
        self.loss = loss
        self.mix_fn = mix_fn
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.device = device
        self.mesh = mesh  # JAX's System(mesh=): the track axis splits over its mp
        self.data_mesh = mesh  # the mesh whose ranks step together
        self.counters: Optional[torch.Tensor] = None  # count_on_device
        self.counter_writes = 0
        self._make_optimizer()
        self.step = 0  # train steps taken, as JAX's TrainState.step
        self.instrument_number_lookup = None
        self.knowledge_engineering_dict = None
        if getattr(mix_fn, "host_side", False):
            with open(_repo_path(kwargs.get("instrument_id_json", "data/instrument_name2id.json"))) as f:
                self.instrument_number_lookup = json.load(f)
            with open(_repo_path(kwargs.get("knowledge_engineering_yaml",
                                            "data/knowledge_engineering.yaml"))) as f:
                self.knowledge_engineering_dict = yaml.safe_load(f)

    # ------------------------------------------------------------ optimizer
    def _make_optimizer(self) -> None:
        """Adam after a global-norm clip, with optax's schedule, gradient
        accumulation and non-finite skipping (system.py:198-228):
        ``torch.optim.Adam``, or ``OptaxAdam`` where ``adam_mu_dtype`` or
        ``flatten_optimizer`` asks for its layout."""
        cfg = self.config
        self.params = list(self.model.parameters())
        mu_dtype = getattr(torch, cfg.adam_mu_dtype) if cfg.adam_mu_dtype else None
        if cfg.flatten_optimizer or (mu_dtype is not None and any(p.dtype != mu_dtype for p in self.params)):
            self.optimizer = OptaxAdam(self.params, cfg.adam_b1, cfg.adam_b2, _ADAM_EPS, mu_dtype,
                                       cfg.flatten_optimizer)
        else:
            self.optimizer = torch.optim.Adam(
                self.params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=_ADAM_EPS
            )
        self.lr_at = lr_schedule(cfg)
        self.updates = 0
        self.notfinite_count = 0
        self._mini_step = 0
        self._acc = None  # running mean of the accumulated gradients

    def use_capturable_optimizer(self) -> None:
        """Let ``torch.optim.Adam`` step on the card without the host
        (``capturable``): its step counts move to the parameters' device and
        it takes a tensor learning rate, as a CUDA graph needs. The bias
        corrections are then computed on the card in float32, not on the host
        in float64. ``OptaxAdam`` needs nothing."""
        if not isinstance(self.optimizer, OptaxAdam):
            _set_capturable(self.optimizer, True)

    def count_on_device(self) -> torch.Tensor:
        """Move the optimizer's counters (updates, the accumulation's
        mini-step, the non-finite count, OptaxAdam's count) into one int64
        tensor on the parameters' device, which steps given a
        ``ScalarTable`` read and advance without the host (a CUDA graph
        replays them: ``train/fused.py``). From then on a host read of a
        counter synchronizes and a host write fills it in place. Returns
        the tensor."""
        if self.counters is None:
            opt = self.optimizer
            optax = isinstance(opt, OptaxAdam)
            values = [self.updates, self._mini_step, self.notfinite_count, opt.count if optax else 0]
            self.counters = torch.tensor(values, dtype=torch.int64).to(self.params[0].device)
            if optax:
                opt.counters = self.counters[3:]
        return self.counters

    def distribute(self, mesh) -> None:
        """Step over ``mesh``'s ranks (the Trainer's mesh): each rank takes
        its dp row's share of the global batch, and the track axis stays
        whole unless the System was built with that mesh (JAX passes the
        CLI's mesh to its Trainer alone, ``main.py:59-87``)."""
        if self.mesh is not None and mesh is not self.mesh:
            raise ValueError("the System was built with another mesh than the one it is to step over")
        self.data_mesh = mesh

    @property
    def mp_sharded(self) -> bool:
        """The track axis splits over the mesh's mp ranks."""
        return self.mesh is not None and self.mesh.shape["mp"] > 1

    def check_replicas(self) -> None:
        """Check that every rank of the mesh holds rank 0's parameters and
        BatchNorm statistics (``parallel.check_replicas``): they start
        equal, drawn from the seed on the CPU or restored from one file."""
        if self.data_mesh is not None:
            check_replicas(list(self.model.parameters()) + list(self.model.buffers()), self.data_mesh)

    def rows(self, local_bs: int) -> Tuple[int, slice]:
        """(the global batch size, this rank's rows of it) for ``local_bs``
        rows a rank: (local_bs, all rows) without a mesh."""
        if self.data_mesh is None:
            return local_bs, slice(None)
        return batch_rows(self.data_mesh, local_bs)

    def draw_ref_params(self, tracks: torch.Tensor, device=None):
        """The reference mix's uniform parameters of the global batch, from
        ``self.generator``, as a sequential step draws them (``mixing/
        naive.py::draw_mix_params``); ``tracks`` are this rank's."""
        total, _ = self.rows(tracks.shape[0])
        return draw_mix_params(tracks, self.mix_console, self.generator, device=device, batch_size=total)

    def reverb_noise(self, seed: int, local_bs: int, device, dtype) -> torch.Tensor:
        """This rank's rows of the global batch's reverb noise for the draw
        ``seed`` (``ops.reverb.reverb_noise_from_seed``)."""
        total, rows = self.rows(local_bs)
        console = self.mix_console
        shape = reverb_noise_shape(total, 2, console.reverb_num_samples, console.reverb_num_taps)
        return reverb_noise_from_seed(seed, shape, device, dtype)[rows]

    @property
    def optimizer_layout(self) -> str:
        """Which optimizer state a checkpoint of this System holds."""
        if isinstance(self.optimizer, OptaxAdam):
            return self.optimizer.layout
        return OptaxAdam.describe(False, self.params[0].dtype)

    # ------------------------------------------------------------ state
    def state_dict(self) -> Dict:
        """Everything a resumed run needs to take the same next step: what
        JAX's TrainState holds (parameters and BatchNorm statistics, the
        optimizer state, the step) with the parts of optax's state that are
        attributes here (the schedule's count, the accumulation's mini-step
        and mean, the non-finite count), and the generator's state. The
        tensors are the live ones: ``utils.checkpoint.save_state`` copies
        them to the host."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "optimizer_layout": self.optimizer_layout,
            "step": self.step,
            "updates": self.updates,
            "notfinite_count": self.notfinite_count,
            "mini_step": self._mini_step,
            "acc": self._acc,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Dict) -> None:
        """Restore a ``state_dict()`` in place, onto the parameters' device:
        every tensor the System already holds keeps its storage, so a CUDA
        graph captured on it (``train/fused.py``) reads the restored state.
        A checkpoint whose optimizer layout (``optimizer_layout``: per-leaf
        or flat, the first moment's dtype) is not this System's raises."""
        # checkpoints written before the optimizer options held torch.optim.Adam's state
        saved = state.get("optimizer_layout", OptaxAdam.describe(False, torch.float32))
        if saved != self.optimizer_layout:
            raise ValueError(
                f"the checkpoint's optimizer state is {saved}, this System's is "
                f"{self.optimizer_layout} (SystemConfig.adam_mu_dtype, flatten_optimizer): "
                "the layouts are not interchangeable"
            )
        self.model.load_state_dict(state["model"])
        if not _copy_adam_state(self.optimizer, state["optimizer"]):
            capturable = not isinstance(self.optimizer, OptaxAdam) and self.optimizer.param_groups[0]["capturable"]
            self.optimizer.load_state_dict(state["optimizer"])
            if not isinstance(self.optimizer, OptaxAdam):  # this System's mode, whatever the writer's
                _set_capturable(self.optimizer, capturable)
        self.step = int(state["step"])
        self.updates = int(state["updates"])
        self.notfinite_count = int(state["notfinite_count"])
        self._mini_step = int(state["mini_step"])
        acc = state["acc"]
        if acc is None or self._acc is None:
            self._acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]
        else:
            torch._foreach_copy_(self._acc, [a.to(p.device) for a, p in zip(acc, self.params)])
        self.generator.set_state(state["generator"])

    def effect_flags(self, epoch: int) -> EffectFlags:
        cfg = self.config
        return EffectFlags(
            use_track_eq=epoch >= cfg.active_eq_epoch,
            use_track_compressor=epoch >= cfg.active_compressor_epoch,
            use_fx_bus=epoch >= cfg.active_fx_bus_epoch,
            use_master_bus=epoch >= cfg.active_master_bus_epoch,
        )

    # ---------------------------------------------------------- the step
    def _host_sample_ke(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """KE reference-mix parameters for one step, sampled on the host.

        The instrument ids and stereo flags are read where the batch holds
        them: the Trainer keeps them on the host, so no step waits on a copy
        back from the card. The NumPy generator is seeded by one 31-bit draw
        from ``self.generator``: the same generator state repeats the draw
        (deterministic validation), a new one gives a new mix."""
        iid = batch.instrument_id.cpu().numpy()
        if self.instrument_number_lookup:
            mdata = instrument_metadata(iid, self.instrument_number_lookup)
        else:
            mdata = [["unknown"] * iid.shape[1] for _ in range(iid.shape[0])]
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self.generator, device=self.generator.device))
        arrays = sample_ke_params(self.knowledge_engineering_dict or {}, mdata,
                                  batch.stereo_info.cpu().numpy(), np.random.default_rng(seed),
                                  self.mix_console)
        return tuple(torch.from_numpy(a) for a in arrays)

    def forward(
        self,
        batch: Batch,
        flags: EffectFlags,
        train: bool,
        ref_params: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        reverb_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """The step's forward (JAX ``System._common``): (loss, metrics,
        outputs). ``reverb_noise`` (the reference render's, the predicted
        render's) replaces the two reverb draws when the fx bus is on. Its
        stages run under ``torch.profiler`` ranges named ``system.ref_mix``
        (with ``system.ke_sample`` for a host-side mix_fn), ``system.model``,
        ``system.render`` and ``system.loss``. Under a mesh ``batch`` is
        this rank's share (``parallel.shard_batch``), and ``ref_params`` and
        ``reverb_noise`` are the global batch's."""
        with bound(self.data_mesh):
            return self._forward(batch, flags, train, ref_params, reverb_noise)

    def _forward(self, batch, flags, train, ref_params, reverb_noise):
        cfg = self.config
        dev = resolve_device(self.device)
        # the instrument ids and stereo flags stay where they are: only the
        # host-side KE sampler reads them
        batch = batch._replace(tracks=batch.tracks.to(dev), track_padding=batch.track_padding.to(dev),
                               ref_mix=batch.ref_mix.to(dev))
        tracks = batch.tracks
        middle = tracks.shape[-1] // 2
        if self.data_mesh is not None:
            ref_params, reverb_noise = self._rank_draws(batch, flags, ref_params, reverb_noise, dev)
        ref_noise, render_noise = reverb_noise if reverb_noise is not None else (None, None)

        ref_param_arrays = None
        if cfg.generate_mix:
            if ref_params is None and getattr(self.mix_fn, "host_side", False):
                with record_function("system.ke_sample"):
                    ref_params = self._host_sample_ke(batch)
            with record_function("system.ref_mix"):
                ref = self.mix_fn(
                    tracks,
                    self.mix_console,
                    self.generator,
                    use_track_input_fader=False,  # reference system.py:235
                    use_track_eq=flags.use_track_eq,
                    use_track_compressor=flags.use_track_compressor,
                    use_fx_bus=flags.use_fx_bus,
                    use_master_bus=flags.use_master_bus,
                    use_output_fader=False,  # reference system.py:241
                    params=ref_params,
                    noise=ref_noise,
                )
                ref_mix = batch_stereo_peak_normalize(ref.mix)
            ref_mix_a = ref_mix[..., :middle]
            ref_mix_b = ref_mix[..., middle:]
            tracks_b = tracks[..., middle:]
            ref_param_arrays = (ref.track_params, ref.fx_bus_params, ref.master_bus_params)
        else:
            ref_mix_a = ref_mix_b = batch.ref_mix
            tracks_b = tracks

        with record_function("system.model"):
            if self.mp_sharded:
                pred_track, pred_fx, pred_master = self._apply_model_mp(
                    tracks_b, ref_mix_a, batch.track_padding, train
                )
            else:
                pred_track, pred_fx, pred_master = self.model(
                    tracks_b, ref_mix_a, batch.track_padding, train=train
                )
        with record_function("system.render"):
            render = self.mix_console(
                tracks_b,
                pred_track,
                pred_fx,
                pred_master,
                use_track_input_fader=True,
                use_track_eq=flags.use_track_eq,
                use_track_compressor=flags.use_track_compressor,
                use_fx_bus=flags.use_fx_bus,
                use_master_bus=flags.use_master_bus,
                use_output_fader=True,
                generator=self.generator,
                noise=render_noise,
            )
        pred_mix_b = render.mix
        with record_function("system.loss"):
            loss, metrics = self._losses(pred_mix_b, ref_mix_b, (pred_track, pred_fx, pred_master),
                                         ref_param_arrays, flags)
        metrics["ref_mix_nonfinite"] = torch.sum(~torch.isfinite(ref_mix_b))
        metrics["pred_mix_nonfinite"] = torch.sum(~torch.isfinite(pred_mix_b))
        if self.data_mesh is not None:
            metrics = self._reduce_metrics(metrics)
        outputs = {
            "pred_mix_b": pred_mix_b,
            "ref_mix_a": ref_mix_a,
            "ref_mix_b": ref_mix_b,
            "pred_params": (pred_track, pred_fx, pred_master),
        }
        return loss, metrics, outputs

    def _rank_draws(self, batch, flags, ref_params, reverb_noise, dev):
        """This rank's rows of the global batch's reference-mix parameters
        and reverb noise: drawn from ``self.generator`` in a sequential
        step's order (the parameters, or KE's seed; the reference render's
        reverb seed; the predicted render's), or taken from the global ones
        a caller passes."""
        cfg = self.config
        bs = batch.tracks.shape[0]
        total, rows = self.rows(bs)
        if cfg.generate_mix:
            if ref_params is None and getattr(self.mix_fn, "host_side", False):
                if batch.instrument_id.shape[0] != total:
                    raise ValueError(
                        f"a host-side mix_fn draws the global batch's {total} mixes from its instrument ids; "
                        f"the batch holds {batch.instrument_id.shape[0]} rows of them"
                    )
                with record_function("system.ke_sample"):
                    ref_params = self._host_sample_ke(batch)
            elif ref_params is None:
                ref_params = self.draw_ref_params(batch.tracks)
            ref_params = tuple(p[rows] for p in ref_params)
        if flags.use_fx_bus:
            if reverb_noise is None:
                seeds = (reverb_noise_seed(self.generator) if cfg.generate_mix else None,
                         reverb_noise_seed(self.generator))
                reverb_noise = tuple(None if s is None else self.reverb_noise(s, bs, dev, batch.tracks.dtype)
                                     for s in seeds)
            else:
                reverb_noise = tuple(None if n is None else n[rows] for n in reverb_noise)
        return ref_params, reverb_noise

    def _apply_model_mp(self, tracks_b, ref_mix_a, padding, train):
        """The model with the track axis over mp (JAX ``_apply_model_mp``,
        ``system.py:268-354``): the track encoder on this rank's tracks,
        the embeddings gathered along tracks; the mix encoder and the
        controller on the whole dp row, replicated over mp."""
        mesh = self.mesh
        assert_mesh_divisible(mesh, tracks_b.shape[0] * mesh.shape["dp"], tracks_b.shape[1],
                              "mp-sharded encoders")
        model = self.model
        if train and getattr(model.track_encoder, "bn_axis_name", None) is None:
            raise ValueError(
                "mp-sharded training needs the model built with "
                f"bn_axis_name={tuple(mesh.axis_names)!r} so BatchNorm "
                "statistics reduce globally inside shard_map"
            )
        te = gather_tracks(model.encode_tracks(track_slice(tracks_b, mesh), train), mesh)
        return model.controller(te, model.encode_mix(ref_mix_a, train), padding)

    def _reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The global batch's metrics from every rank's (one all-reduce):
        the loss terms' mean over dp, the non-finite counts' sum over dp
        (each dp row's value is whole on its mp ranks)."""
        mesh = self.data_mesh
        vals = torch.stack([v.detach().to(torch.float64) for v in metrics.values()])
        torch.distributed.all_reduce(vals, group=mesh.group(mesh.axis_names))
        out = {}
        for v, (k, m) in zip(vals, metrics.items()):
            if k.endswith("_nonfinite"):  # summed over dp, each dp row's on its mp ranks
                out[k] = (v / mesh.shape["mp"]).round().to(m.dtype)
            else:
                out[k] = (v / mesh.size).to(m.dtype)
        return out

    def _reduce_gradients(self, grads) -> None:
        """Sum ``grads`` over the mesh's ranks in place (one all-reduce a
        dtype) and divide: the track encoder's by dp where the track axis
        splits over mp (its partial gradients add up over mp), every other
        by dp * mp (whole on each mp rank: their mean over dp)."""
        mesh = self.data_mesh
        by_dtype: Dict[torch.dtype, list] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            torch.distributed.all_reduce(flat, group=mesh.group(mesh.axis_names))
            torch._foreach_copy_(gs, [piece.view_as(g) for g, piece in zip(gs, flat.split([g.numel() for g in gs]))])
        track = {id(p) for p in self.model.track_encoder.parameters()} if self.mp_sharded else set()
        for divisor, members in ((mesh.shape["dp"], [g for p, g in zip(self.params, grads) if id(p) in track]),
                                 (mesh.size, [g for p, g in zip(self.params, grads) if id(p) not in track])):
            if members:
                torch._foreach_div_(members, float(divisor))

    def _losses(self, pred_mix_b, ref_mix_b, pred_params, ref_param_arrays, flags):
        """The mix loss (a scalar or named terms) and the optional
        parameter loss: (loss, metrics)."""
        cfg = self.config
        pred_track, pred_fx, pred_master = pred_params
        loss = pred_mix_b.new_zeros(())
        metrics: Dict[str, torch.Tensor] = {}
        if cfg.use_mix_loss:
            mix_loss = self.loss(pred_mix_b, ref_mix_b)
            if isinstance(mix_loss, dict):
                for name, val in mix_loss.items():
                    v = torch.mean(val)
                    loss = loss + v
                    metrics[name] = v
            else:
                loss = loss + mix_loss
        if cfg.use_param_loss and ref_param_arrays is not None:
            tp, fp, mp = ref_param_arrays
            p_loss = torch.mean(torch.square(pred_track - tp))
            if flags.use_fx_bus:
                p_loss = p_loss + torch.mean(torch.square(pred_fx - fp))
            if flags.use_master_bus:
                p_loss = p_loss + torch.mean(torch.square(pred_master - mp))
            loss = loss + p_loss
            metrics["param_loss"] = p_loss

        metrics["loss"] = loss
        return loss, metrics

    def gradients(
        self,
        batch: Batch,
        flags: EffectFlags,
        ref_params: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        reverb_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The first half of a train step: the forward in training mode (it
        updates the BatchNorm running statistics) and the backward, which
        leaves every parameter's gradient in ``.grad`` (zeros for those the
        loss does not reach, as ``jax.grad`` gives). Returns the step's
        metrics with ``grad_norm``, the gradients' global norm."""
        for p in self.params:
            p.grad = None
        loss, metrics, _ = self.forward(batch, flags, True, ref_params, reverb_noise)
        metrics["grad_norm"] = self.backward(loss)
        return {k: v.detach() for k, v in metrics.items()}

    def backward(self, loss: torch.Tensor) -> torch.Tensor:
        """Backpropagate ``loss`` into ``.grad`` (zeros where it does not
        reach, as ``jax.grad`` gives) under the range ``system.backward``;
        under a mesh, reduce the gradients over its ranks. Returns the
        gradients' global norm."""
        with bound(self.data_mesh), record_function("system.backward"):
            loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.data_mesh is not None:
            with record_function("system.grad_all_reduce"):
                self._reduce_gradients([p.grad for p in self.params])
        return _global_norm([p.grad for p in self.params])

    @torch.no_grad()
    @record_function("system.optimizer")
    def apply_gradients(self, grad_norm: torch.Tensor,
                        scalars: Union[UpdateScalars, ScalarTable, None] = None) -> Dict[str, int]:
        """The second half of a train step: optax's
        ``apply_if_finite(MultiSteps(chain(clip_by_global_norm, adam)))``
        on the gradients in ``.grad``, whose global norm is ``grad_norm``
        (``optax.flatten`` around the chain with ``flatten_optimizer``).
        After it, ``.grad`` holds the clipped gradients the optimizer took;
        with ``flatten_optimizer`` it took a clipped, ravelled copy, and
        ``.grad`` keeps the unclipped ones. ``scalars`` replace the learning
        rate and bias corrections of the counters (``update_scalars``); a
        ``ScalarTable`` lets the device decide (``_apply_on_device``)."""
        cfg = self.config
        metrics = {}
        grads = [p.grad for p in self.params]
        if isinstance(scalars, ScalarTable):
            return self._apply_on_device(grads, grad_norm, scalars)
        if cfg.skip_nonfinite_updates > 0:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            metrics["notfinite_count"] = self.notfinite_count
            if not finite and self.notfinite_count <= cfg.skip_nonfinite_updates:
                return metrics
        k = cfg.accumulate_grad_batches
        if k > 1:
            n = self._mini_step
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # a device tensor divides as the device-decided step's does (a
            # host number divides otherwise on the card)
            divisor = torch.full((), n + 1, dtype=torch.int64, device=grads[0].device)
            for a, g in zip(self._acc, grads):
                a.mul_(n).add_(g).div_(divisor)
            self._mini_step = (n + 1) % k
            if self._mini_step:
                return metrics
            for a, g in zip(self._acc, grads):
                g.copy_(a)
                a.zero_()
            grad_norm = _global_norm(grads)
        grads = self._clip(grads, grad_norm)
        if scalars is None:
            scalars = self.update_scalars(self.updates, getattr(self.optimizer, "count", 0) + 1)
            if grads[0].is_cuda and (isinstance(self.optimizer, OptaxAdam)
                                     or self.optimizer.param_groups[0].get("capturable")):
                # the card divides by a host float otherwise than by a device
                # tensor: an eager step takes the scalars as a replay does
                scalars = UpdateScalars(*(torch.full((), float(v), dtype=torch.float32, device=grads[0].device)
                                          for v in scalars))
        lr = scalars.lr
        if isinstance(self.optimizer, OptaxAdam):
            self.optimizer.step(grads, lr, (scalars.bc1, scalars.bc2))
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
        self.updates += 1
        return metrics

    def _clip(self, grads, grad_norm: torch.Tensor):
        """The gradients the chain's Adam takes: ravelled into one vector
        with ``flatten_optimizer``, then clipped by their global norm."""
        cfg = self.config
        if cfg.flatten_optimizer:  # one ravelled vector; its norm is the same global norm
            grads = [torch.cat([g.reshape(-1) for g in grads])]
        # clip_by_global_norm as optax takes it, (g / |g|) * c where |g| >= c,
        # else g as it is (g / 1 * 1), on the card, no sync
        clip = grad_norm >= cfg.grad_clip
        torch._foreach_div_(grads, torch.where(clip, grad_norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, cfg.grad_clip, 1.0).to(grad_norm.dtype))
        return grads

    def _apply_on_device(self, grads, grad_norm: torch.Tensor, table: ScalarTable) -> Dict[str, torch.Tensor]:
        """``apply_gradients`` with its decisions taken on the device, from
        the counters of ``count_on_device`` (optax's state as data, as
        JAX's jitted step holds it): ``finite`` (every gradient finite);
        ``nf = 0 if finite else nf + 1``; ``apply = finite or nf > skip``;
        the accumulated mean ``acc = (acc * m + g) / (m + 1)`` and ``m = (m
        + 1) % a`` where ``apply``; ``update = apply and m == 0``. The clip
        and Adam always run, and every tensor they change keeps its old
        value where ``update`` is false (a ``torch.where``, so that a NaN
        the update made is dropped too); the learning rate and corrections
        come from ``table`` at the update and OptaxAdam counts. The host
        reads nothing, so a CUDA graph holds it."""
        cfg = self.config
        updates, mini, nf, count = self.counters.unbind()
        metrics = {}
        apply = None  # None: every step counts
        if cfg.skip_nonfinite_updates > 0:
            # g * 0 is 0 where g is finite, NaN where not; a norm of zeros
            # cannot overflow
            finite = torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0))).sum() == 0
            nf.copy_(torch.where(finite, 0, nf + 1))
            metrics["notfinite_count"] = nf.clone()
            apply = finite | (nf > cfg.skip_nonfinite_updates)
        update = apply
        k = cfg.accumulate_grad_batches
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            divisor = mini + 1  # as the host's path divides, by a device tensor
            for a, g in zip(self._acc, grads):
                if apply is None:
                    a.mul_(mini).add_(g).div_(divisor)
                else:
                    torch.where(apply, a.mul(mini).add_(g).div_(divisor), a, out=a)
            stepped = torch.remainder(divisor, k)
            mini.copy_(stepped if apply is None else torch.where(apply, stepped, mini))
            update = mini == 0 if apply is None else apply & (mini == 0)
            torch._foreach_copy_(grads, self._acc)
            for a in self._acc:
                a.masked_fill_(update, 0.0)
            grad_norm = _global_norm(grads)
        if update is None:  # nothing to decide: every step updates
            update = torch.ones((), dtype=torch.bool, device=mini.device)
        grads = self._clip(grads, grad_norm)
        rows = table.lr.shape[0]
        torch.index_select(table.lr, 0, torch.remainder(updates, rows).view(1), out=table.lr_now.view(1))
        lr = table.lr_now
        opt = self.optimizer
        if isinstance(opt, OptaxAdam):
            at = torch.remainder(count, rows).view(1)
            corrections = (table.bc1.index_select(0, at).view(()), table.bc2.index_select(0, at).view(()))
            with _unless(update, opt.params + opt.mu + opt.nu):
                opt.apply(grads, lr, corrections)
            count.add_(update)
        else:
            _init_adam_state(opt)
            host = not opt.param_groups[0]["capturable"]
            if host:  # on the CPU: it takes the host's float, and keeps the last update's
                last, lr = opt.param_groups[0]["lr"], self.lr_at(int(updates))
            state = [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
            with _unless(update, self.params + state):
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.step()
            if host and not bool(update):
                for group in opt.param_groups:
                    group["lr"] = last
        updates.add_(update)
        return metrics

    def update_scalars(self, updates: int, count: int) -> UpdateScalars:
        """The scalars of the update after ``updates`` updates, OptaxAdam's
        ``count``-th (torch.optim.Adam computes its own corrections)."""
        if isinstance(self.optimizer, OptaxAdam):
            return UpdateScalars(self.lr_at(updates), *self.optimizer.corrections(count))
        return UpdateScalars(self.lr_at(updates), 1.0, 1.0)

    def train_step(
        self,
        batch: Batch,
        flags: EffectFlags,
        ref_params: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        reverb_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        scalars: Optional[UpdateScalars] = None,
    ) -> Dict[str, torch.Tensor]:
        """One train step in place (JAX ``make_train_step``, system.py:541):
        parameters, BatchNorm statistics and optimizer state move on.
        ``ref_params`` (track, fx bus, master bus), normalized, replace the
        reference mix's random draw, ``reverb_noise`` the reverb's, and
        ``scalars`` the update's learning rate and bias corrections.
        Returns the metrics: loss (and a dict loss's named terms), the two
        non-finite counts, grad_norm (and notfinite_count when skipping)."""
        metrics = self.gradients(batch, flags, ref_params, reverb_noise)
        metrics.update(self.apply_gradients(metrics["grad_norm"], scalars))
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(
        self,
        batch: Batch,
        flags: EffectFlags,
        ref_params: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
        reverb_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """One evaluation step (JAX ``make_eval_step``, system.py:602):
        BatchNorm on its running statistics, nothing updated. Returns
        (metrics, outputs) with the predicted and reference mixes and the
        normalized predicted parameters."""
        _, metrics, outputs = self.forward(batch, flags, False, ref_params, reverb_noise)
        return metrics, outputs


class OptaxAdam:
    """``optax.adam`` with ``mu_dtype``, optionally under ``optax.flatten``,
    stepping ``params`` in place.

    Each step takes optax's operations in optax's order
    (``optax.scale_by_adam``, then ``-lr * update`` added to the
    parameters): ``mu32 = (1 - b1) * g + b1 * mu``, the product b1 * mu
    rounded to mu's dtype as JAX's weakly-typed product is (b1 itself
    rounded to it first); ``nu = (1 - b2) * g * g + b2 * nu``; the update
    ``(mu32 / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` from the
    unrounded ``mu32``, the corrections in float32; then ``mu`` stores
    ``mu32`` in its dtype. ``mu_dtype`` None keeps the parameters' dtype.

    With ``flat``, ``step`` takes one ravelled gradient (the leaves in
    ``params`` order) and keeps one ``mu`` and one ``nu`` of n_params
    each; the update is unravelled onto the parameters.
    """

    count = _Counter(0)  # updates taken (``System.count_on_device`` may hold it)

    def __init__(self, params, b1: float, b2: float, eps: float,
                 mu_dtype: Optional[torch.dtype] = None, flat: bool = False):
        self.counters: Optional[torch.Tensor] = None
        self.counter_writes = 0
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.flat = flat
        if flat:
            p0 = self.params[0]
            n = sum(p.numel() for p in self.params)
            self.nu = [torch.zeros(n, dtype=p0.dtype, device=p0.device)]
        else:
            self.nu = [torch.zeros_like(p) for p in self.params]
        self.mu = [torch.zeros_like(v, dtype=mu_dtype or v.dtype) for v in self.nu]
        self.count = 0

    @staticmethod
    def describe(flat: bool, mu_dtype: torch.dtype) -> str:
        return f"{'flat' if flat else 'per-leaf'}, mu {str(mu_dtype).replace('torch.', '')}"

    @property
    def layout(self) -> str:
        return self.describe(self.flat, self.mu[0].dtype)

    def corrections(self, count: int) -> Tuple[float, float]:
        """The bias corrections 1 - b1^count, 1 - b2^count in float32, as
        optax takes decay ** count."""
        return tuple(float(1.0 - torch.tensor(b, dtype=torch.float32) ** count) for b in (self.b1, self.b2))

    @torch.no_grad()
    def step(self, grads, lr, corrections=None) -> None:
        """One update from ``grads`` (the clipped gradients, in the
        state's layout) at learning rate ``lr``, with the bias
        ``corrections`` (bc1, bc2) of this update (default: from the
        count). ``lr`` and the corrections may be 0-dim tensors on the
        gradients' device."""
        self.count += 1
        self.apply(grads, lr, self.corrections(self.count) if corrections is None else corrections)

    @torch.no_grad()
    def apply(self, grads, lr, corrections) -> None:
        """``step``'s update at learning rate ``lr`` and bias corrections
        (bc1, bc2), without moving the count."""
        b1, b2 = self.b1, self.b2
        bc1, bc2 = corrections
        b1_mu = float(torch.tensor(b1, dtype=self.mu[0].dtype))
        mu32 = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu32, torch._foreach_mul(self.mu, b1_mu))
        torch._foreach_copy_(self.mu, mu32)
        tmp = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(tmp, 1.0 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, tmp)
        torch._foreach_div_(mu32, bc1)  # mu_hat
        torch._foreach_copy_(tmp, self.nu)
        torch._foreach_div_(tmp, bc2)  # nu_hat
        torch._foreach_sqrt_(tmp)
        torch._foreach_add_(tmp, self.eps)
        torch._foreach_div_(mu32, tmp)
        torch._foreach_mul_(mu32, -lr)
        if self.flat:
            mu32 = [u.view_as(p) for u, p in zip(mu32[0].split([p.numel() for p in self.params]),
                                                  self.params)]
        torch._foreach_add_(self.params, mu32)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict()`` of the same layout into the live state."""
        for live, saved in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            if live.shape != saved.shape or live.dtype != saved.dtype:
                raise ValueError(f"optimizer state {tuple(saved.shape)} {saved.dtype} does not fit "
                                 f"{tuple(live.shape)} {live.dtype}")
            live.copy_(saved)
        self.count = int(state["count"])


@contextlib.contextmanager
def _unless(update: torch.Tensor, tensors):
    """Run the block, then give back each of ``tensors`` its value from
    before it where the 0-dim bool ``update`` is false."""
    old = [torch.empty_like(t) for t in tensors]
    torch._foreach_copy_(old, tensors)
    yield
    for t, o in zip(tensors, old):
        torch.where(update, t, o, out=t)


def _init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Give every parameter of ``torch.optim.Adam`` the state its first
    ``step()`` would make (a zero step count, zero moments), so that an
    update the device may drop has a state to keep."""
    capturable = optimizer.param_groups[0]["capturable"]
    dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=dtype, device=p.device if capturable else "cpu")
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _set_capturable(optimizer: torch.optim.Adam, capturable: bool) -> None:
    """Put ``torch.optim.Adam`` in or out of its capturable mode, its step
    counts on the parameters' device or on the host as that mode wants."""
    for group in optimizer.param_groups:
        group["capturable"] = capturable
    for p, state in optimizer.state.items():
        if "step" in state:
            state["step"] = state["step"].to(p.device if capturable else "cpu", torch.float32)


def _copy_adam_state(optimizer, saved: Dict) -> bool:
    """Copy a ``torch.optim.Adam`` state dict into the optimizer's live
    state tensors and its groups' hyperparameters, where it holds a tensor
    of the same shape for each; False (nothing copied) otherwise, or for
    another optimizer."""
    if not isinstance(optimizer, torch.optim.Adam):
        return False
    live = optimizer.state_dict()
    if live["state"].keys() != saved["state"].keys() or len(live["param_groups"]) != len(saved["param_groups"]):
        return False
    pairs = [(live["state"][i][k], v) for i, st in saved["state"].items() for k, v in st.items()]
    if not all(k in live["state"][i] for i, st in saved["state"].items() for k in st) or any(
            a.shape != b.shape for a, b in pairs):
        return False
    with torch.no_grad():
        for a, b in pairs:
            a.copy_(b)
    for group, saved_group in zip(optimizer.param_groups, saved["param_groups"]):
        group.update({k: v for k, v in saved_group.items() if k not in ("params", "capturable")})
    return True


def _global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))
