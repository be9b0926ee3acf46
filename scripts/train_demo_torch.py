"""Training demo of the PyTorch port at the bf16 recipe (configs/models/naive+tpu.yaml).

The port's counterpart of ``scripts/train_demo_tpu.py``: the port's
``Trainer`` (background prefetch, deterministic probe validation, the
logged steps/s) at the full reference shape (batch 4 x 8 tracks x 262,144
samples) with the full-width model in bf16 compute and Adam's first moment
in bf16, recording two loss trajectories:

  * the per-step TRAIN loss trail (noisy by construction: each Method-1
    step renders a fresh random-parameter reference mix);
  * a PROBE curve: a fixed held-out set of stem batches evaluated every
    epoch with ``deterministic_val=True``, so every pass draws the SAME
    reference-mix parameters and the curve isolates the model's learning
    from the task's noise. The "equal-gain sum" baseline (the no-model mix
    of the same probe stems against the same reference mixes) anchors the
    scale; ``scripts/probe_floor_torch.py`` gives its oracle floor.

Data modes (``DEMO_MODE``):

  * ``device`` (default): a FRESH batch of stems synthesized on the device
    every step (white noise through a random one-pole colour, by rfft) from
    a generator seeded per batch, so no example repeats and no host copy
    slows the run;
  * ``host``: fresh stems synthesized by NumPy each step and copied by the
    prefetch thread;
  * ``fixed``: a pool of 4 host-synthesized batches, placed on the device.

The stems and the reference mixes come from ``torch.Generator``s, not from
JAX's keys, so no curve repeats the JAX demo's values: compare their shapes
(the drop below the baseline, the distance to the floor).

Knobs: ``DEMO_MODE``, ``DEMO_LR`` (1e-4), ``DEMO_SCHEDULE`` ("step"),
``DEMO_OUT`` (logs/train_demo_torch.json), ``DEMO_SAVE_CKPT`` (a directory:
save the final state there), ``DEMO_DEVICE`` (as ``--device``). Writes its
summary under the working directory. Runs on the CUDA device, or on the
CPU with ``--device cpu`` (``--toy``: a tiny model on 2 x 2 x 8,192 batches
and one probe batch, seconds a step on a CPU):

    python3 scripts/train_demo_torch.py [steps_per_epoch] [epochs] [--device cpu] [--toy]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.losses import MultiResolutionSTFTLoss  # noqa: E402
from diffmst_torch.mixing import naive_random_mix  # noqa: E402
from diffmst_torch.mixing.naive import draw_mix_params  # noqa: E402
from diffmst_torch.models import MixStyleTransferModel  # noqa: E402
from diffmst_torch.train import System, SystemConfig, Trainer  # noqa: E402
from diffmst_torch.train.trainer import _fold_in  # noqa: E402
from diffmst_torch.utils.audio import batch_stereo_peak_normalize  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

SR = 44100.0
BS, NT, T = 4, 8, 262144
SEED = 42  # the Trainer's default; deterministic validation seeds from SEED + 1
N_PROBE = 4
# configs/models/naive+tpu.yaml's model: the full widths, bf16 compute, no remat
MODEL = dict(compute_dtype="bfloat16", remat_encoders=False)
# --toy: a model and batches small enough for seconds a step on a CPU
TOY_MODEL = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=32, cnn_base_width=2,
                 compute_dtype="bfloat16")
TOY_T = 8192
# the reference mix's effects in every epoch of the demo (active_fx_bus_epoch 1000)
FLAGS = dict(use_track_eq=True, use_track_compressor=True, use_fx_bus=False, use_master_bus=True)


def synth_tracks(generator: torch.Generator, bs: int, nt: int, t: int) -> torch.Tensor:
    """(bs, nt, t) fresh stems on the generator's device: white noise through
    a random one-pole colour per track (a ~ U[0, 0.95), applied by rfft),
    each track peak-normalized to -48 dBFS."""
    dev = generator.device
    x = torch.randn((bs, nt, t), generator=generator, device=dev)
    a = torch.rand((bs, nt, 1), generator=generator, device=dev) * 0.95
    h = (1.0 - a) / (1.0 - a * torch.exp(-2j * np.pi * torch.fft.rfftfreq(t, device=dev)).to(torch.complex64))
    x = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * h, n=t, dim=-1)
    peak = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return x / torch.clamp(peak, min=1e-9) * 10 ** (-48 / 20)


def synth_tracks_host(rng: np.random.Generator, bs: int, nt: int, t: int) -> np.ndarray:
    """``synth_tracks`` in NumPy from ``rng`` (``train_demo_tpu.py``'s host
    synthesis, draw for draw)."""
    tracks = rng.normal(size=(bs, nt, t)).astype(np.float32)
    a = rng.uniform(0.0, 0.95, size=(bs, nt, 1)).astype(np.float32)
    h = (1.0 - a) / (1.0 - a * np.exp(-2j * np.pi * np.fft.rfftfreq(t)).astype(np.complex64))
    tracks = np.fft.irfft(np.fft.rfft(tracks, axis=-1) * h, n=t, axis=-1)
    tracks = tracks.astype(np.float32)
    peak = np.abs(tracks).max(axis=-1, keepdims=True)
    return tracks / np.maximum(peak, 1e-9) * 10 ** (-48 / 20)


class SyntheticDM:
    """A datamodule of non-repeating stem batches (see the module doc).

    The val loader yields ``n_probe`` FIXED batches, synthesized from seeds
    disjoint from the training stream's (batch i of the training stream
    from ``_fold_in(1000 + seed, i)``, probe batch i from ``_fold_in(2000 +
    seed, i)``); with the Trainer's ``deterministic_val`` every validation
    pass draws the same reference mixes, so the val curve compares across
    epochs. ``device`` and ``host`` batches are made as the loader is
    walked (the Trainer's prefetch thread); ``fixed`` batches and the probe
    set's are made here.
    """

    def __init__(self, n_train, mode="device", n_probe=None, seed=0, device=None, shape=None):
        self.mode = mode
        self.n_train = n_train
        self.n_probe = N_PROBE if n_probe is None else n_probe
        self.seed = seed
        self.device = resolve_device(device)
        self.shape = shape = shape or (BS, NT, T)
        self.batch_size = shape[0]
        self.rng = np.random.default_rng(seed)
        bs, nt, t = shape
        self._zero_i = np.zeros((bs, nt), np.int32)
        self._zero_b = torch.zeros((bs, nt), dtype=torch.bool, device=self.device)
        # Method 1 renders its own reference mix; Batch.ref_mix is unused
        # but must exist with the right shape
        self._zero_ref = torch.zeros((bs, 2, t), device=self.device)
        self.pool = None
        if mode == "fixed":
            self.pool = [self._wrap(torch.from_numpy(synth_tracks_host(self.rng, *shape)).to(self.device))
                         for _ in range(4)]
        self.probe = [self._synth(2000 + seed, i) for i in range(self.n_probe)]

    def _synth(self, base: int, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(_fold_in(base, i))
        return synth_tracks(gen, *self.shape)

    def _wrap(self, tracks):
        return (tracks, self._zero_i, self._zero_i, self._zero_b, self._zero_ref, ["synthetic"] * self.batch_size)

    def probe_tracks(self, i: int) -> torch.Tensor:
        return self.probe[i]

    def train_dataloader(self):
        for i in range(self.n_train):
            if self.mode == "device":
                yield self._wrap(self._synth(1000 + self.seed, i))
            elif self.mode == "host":
                yield self._wrap(synth_tracks_host(self.rng, *self.shape))
            else:
                yield self.pool[i % len(self.pool)]

    def val_dataloader(self):
        for i in range(self.n_probe):
            yield self._wrap(self.probe_tracks(i))


def on_device(raw, device):
    """A collated host batch (tracks, stereo, instr, padding, mix, names) with
    its tracks, padding and mix on ``device``; the instrument ids and stereo
    flags stay on the host, as the Trainer keeps them."""
    tracks, stereo, instr, padding, mix, names = raw
    tracks, padding, mix = (torch.from_numpy(a).to(device) for a in (tracks, padding, mix))
    return tracks, stereo, instr, padding, mix, names


class _CollectVal:
    def __init__(self):
        self.losses = []

    def on_log(self, tag, metrics):
        if tag == "val" and "loss" in metrics:
            self.losses.append(float(metrics["loss"]))


def probe_params(tracks: torch.Tensor, console, i: int, seed: int = SEED):
    """The reference-mix parameters that the Trainer's deterministic
    validation draws for probe batch ``i``: from a generator seeded
    ``_fold_in(seed + 1, i)`` (``Trainer._run_validation``), in the
    System's draw order (``mixing/naive.py::draw_mix_params``)."""
    return draw_mix_params(tracks, console, torch.Generator().manual_seed(_fold_in(seed + 1, i)))


def probe_reference(tracks: torch.Tensor, console, params) -> torch.Tensor:
    """The second half of the peak-normalized reference mix that the probe
    validation renders from ``params`` (``System.forward``: no input or
    output fader, the demo's effects)."""
    ref = naive_random_mix(tracks, console, None, use_track_input_fader=False, use_output_fader=False,
                           params=params, **FLAGS)
    return batch_stereo_peak_normalize(ref.mix)[..., tracks.shape[-1] // 2:]


@torch.no_grad()
def probe_baseline(dm, console, loss_fn, n_probe: int, params=None) -> float:
    """Loss of the no-model mix on the probe set: the equal-gain mono sum of
    the model-visible half, peak-normalized, against the SAME reference
    mixes that the probe validation renders (``probe_params``), or against
    the mixes of ``params`` (one (track, fx bus, master bus) triple a probe
    batch) where given. The mean over the probe batches."""
    vals = []
    for i in range(n_probe):
        tracks = dm.probe_tracks(i)
        ref_b = probe_reference(tracks, console, probe_params(tracks, console, i) if params is None else params[i])
        s = torch.sum(tracks[..., tracks.shape[-1] // 2:], dim=1)
        sum_b = batch_stereo_peak_normalize(torch.stack([s, s], dim=1))
        vals.append(float(loss_fn(sum_b, ref_b)))
    return float(np.mean(vals))


def toy_probe(toy: bool) -> dict:
    """``SyntheticDM``'s shape and probe size for ``--toy``."""
    return dict(shape=(2, 2, TOY_T), n_probe=1) if toy else {}


def card(dev: torch.device):
    """(the device's name, ``nvidia-smi``'s "name, power limit" line or
    None)."""
    if dev.type != "cuda":
        return dev.type, None
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        smi = None
    return torch.cuda.get_device_name(dev), smi


def build_system(dev, loss, model=None, **config) -> System:
    """The demo's System on ``dev``: the model of ``MODEL`` drawn from a CPU
    generator seeded ``SEED`` (the same weights for ``validate`` and
    ``fit``), ``AdvancedMixConsole``, ``loss``, Adam's first moment in bf16,
    and ``config``'s SystemConfig fields."""
    model = MixStyleTransferModel.build(**(MODEL if model is None else model), device=dev,
                                        generator=torch.Generator().manual_seed(SEED))
    cfg = dict(active_fx_bus_epoch=1000, adam_mu_dtype="bfloat16")
    cfg.update(config)
    return System(model, AdvancedMixConsole(SR, device=str(dev)), loss, SystemConfig(**cfg), device=dev)


def trail_summary(trainer, digits=4) -> dict:
    """The train-loss trail and its thirds, and the median logged steps/s."""
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    sps = [h["steps_per_sec"] for h in trainer.history if "steps_per_sec" in h]
    third = max(1, len(losses) // 3)
    first_mean = float(np.mean(losses[:third])) if losses else float("nan")
    last_mean = float(np.mean(losses[-third:])) if losses else float("nan")
    bs = trainer.datamodule.batch_size
    t = trainer.datamodule.shape[-1]
    return {
        "loss_trail": [round(float(x), digits) for x in losses],
        "smoothed_first_third": round(first_mean, digits),
        "smoothed_last_third": round(last_mean, digits),
        "loss_dropped": bool(losses and last_mean < first_mean),
        "sustained_steps_per_sec": round(float(np.median(sps)), 3) if sps else None,
        "realtime_factor": round(float(np.median(sps)) * bs * t / SR, 1) if sps else None,
    }


def parse(argv, what, steps=None, epochs=None):
    """The demos' command line: [steps_per_epoch] [epochs] (where the demo
    trains), ``--device`` and ``--toy``."""
    ap = argparse.ArgumentParser(description=what)
    if steps is not None:
        ap.add_argument("steps_per_epoch", nargs="?", type=int, default=steps)
        ap.add_argument("epochs", nargs="?", type=int, default=epochs)
    ap.add_argument("--device", default=os.environ.get("DEMO_DEVICE"),
                    help="cpu, or a CUDA device (default: the card; DEMO_DEVICE)")
    ap.add_argument("--toy", action="store_true",
                    help=f"a tiny model on {TOY_T}-sample batches of a few tracks, one probe batch (a CPU's size)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv, __doc__.splitlines()[0], 500, 24)
    steps_per_epoch, epochs = args.steps_per_epoch, args.epochs
    dev = resolve_device(args.device)
    use_full_float32()
    mode = os.environ.get("DEMO_MODE", "device")
    lr = float(os.environ.get("DEMO_LR", "1e-4"))
    schedule = os.environ.get("DEMO_SCHEDULE", "step")
    out_path = os.environ.get("DEMO_OUT", "logs/train_demo_torch.json")
    save_ckpt = os.environ.get("DEMO_SAVE_CKPT", "")  # a directory: the final state
    name, smi = card(dev)
    print("device:", dev, name, smi, "mode:", mode, "lr:", lr, "schedule:", schedule, flush=True)

    loss_fn = MultiResolutionSTFTLoss()
    system = build_system(dev, loss_fn, TOY_MODEL if args.toy else None, steps_per_epoch=steps_per_epoch,
                          max_epochs=epochs, lr=lr, schedule=schedule)
    dm = SyntheticDM(steps_per_epoch, mode=mode, device=dev, **toy_probe(args.toy))
    collect = _CollectVal()
    trainer = Trainer(
        system, dm, max_epochs=epochs, ckpt_dir="logs/train_demo_ckpt_torch", log_every_n_steps=10,
        check_val_every_n_epoch=1,
        deterministic_val=True,  # the same reference-mix draws every probe pass
        enable_checkpointing=False, callbacks=[collect], seed=SEED,
    )
    baseline = probe_baseline(dm, system.mix_console, loss_fn, dm.n_probe)
    print(f"[probe] equal-gain-sum baseline loss = {baseline:.4f}", flush=True)

    # the untrained anchor: the probe set before any step, from the weights
    # that fit() starts from; validate() moves neither them nor the
    # training generator (fit() seeds that from SEED)
    untrained = trainer.validate()["loss"]
    print(f"[probe] untrained model loss = {untrained:.4f}", flush=True)

    t0 = time.time()
    trainer.fit()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if save_ckpt:
        trainer.ckpt_dir = save_ckpt
        trainer._save("last", next_epoch=epochs)
        print(f"[ckpt] final state saved to {save_ckpt}/last", flush=True)

    trail = trail_summary(trainer)
    probe = collect.losses  # the untrained pass, then one a epoch
    summary = {
        "backend": name,
        "power_limit": smi,
        "shape": "x".join(map(str, dm.shape)),
        "recipe": "bf16 compute, no remat, Adam mu bf16 (configs/models/naive+tpu.yaml)",
        "lr": lr,
        "schedule": schedule,
        "data_mode": mode,
        "distinct_batches": ("fresh every step (device-synthesized)" if mode == "device"
                             else "fresh every step (host)" if mode == "host" else 4),
        "steps": int(system.step),
        "wall_s": round(wall, 1),
        **{k: trail[k] for k in ("loss_trail", "smoothed_first_third", "smoothed_last_third", "loss_dropped")},
        "probe": {
            "what": (f"{dm.n_probe} held-out fixed stem batches, deterministic ref-mix draws per pass "
                     "(deterministic_val); first entry of curve = untrained model (pre-fit validate())"),
            "equal_gain_sum_baseline": round(baseline, 4),
            "untrained_loss": round(untrained, 4),
            "curve": [round(x, 4) for x in probe],
            "first": round(probe[0], 4),
            "last": round(probe[-1], 4),
            "dropped": bool(probe[-1] < probe[0]),
            "beats_baseline": bool(probe[-1] < baseline),
        },
        "sustained_steps_per_sec": trail["sustained_steps_per_sec"],
        "realtime_factor": trail["realtime_factor"],
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
