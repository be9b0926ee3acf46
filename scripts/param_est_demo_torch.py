"""Parameter-estimation pretraining demo of the PyTorch port, with the HPSS
separator.

The port's counterpart of ``scripts/param_est_demo.py``: the same synthetic
songs from the same NumPy seed (drums, bass, a chord pad and a vibrato
lead), the same models (``AdvancedMixConsole``, a ``SpectrogramEncoder`` of
embedding 64 and Cnn14 width 8, a ``ParameterProjector``), the
``Remixer`` with ``hpss_separator``, and the same summary keys. It trains
``ParameterEstimationSystem`` and records the parameter-MSE trail on the
training batches and on held-out songs remixed once.

The bar: predicting 0.5 for every parameter scores the sum of the group
scales times Var(U(0, 1)) = (27 + 8) / 12 + 25 / 12 + 26 / 12 = 7.17.

Writes logs/param_est_demo_torch.json under the working directory. Runs on
the CUDA device, or on the CPU with ``--device cpu``:

    python3 scripts/param_est_demo_torch.py [steps] [bs] [lr] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.models import ParameterProjector, SpectrogramEncoder  # noqa: E402
from diffmst_torch.models.separator import hpss_separator  # noqa: E402
from diffmst_torch.train import ParameterEstimationSystem, Remixer  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

SR = 44100.0
T = 512 * 128  # >= 128 STFT frames for the Cnn14 pool schedule


def synth_song(rng: np.random.Generator) -> np.ndarray:
    """One (2, T) stereo 'song': kick and snare bursts, bass with harmonics,
    a chord pad and a vibrato lead, each at its own level and constant-power
    stereo position (``scripts/param_est_demo.py``'s, draw for draw)."""
    t = np.arange(T) / SR
    out = np.zeros((2, T), np.float32)

    def place(sig, pan, level_db):
        g = 10.0 ** (level_db / 20.0)
        theta = pan * np.pi / 2.0
        out[0] += np.float32(g * np.cos(theta)) * sig
        out[1] += np.float32(g * np.sin(theta)) * sig

    drums = np.zeros(T, np.float32)
    period = int(0.5 * SR)
    for k in range(0, T, period):
        n = min(4096, T - k)
        env = np.exp(-np.arange(n) / (0.02 * SR))
        drums[k: k + n] += env * np.sin(2 * np.pi * 55 * t[:n]) * 2.0
        s = k + period // 2
        if s + n < T:
            drums[s: s + n] += env * rng.normal(size=n).astype(np.float32) * 0.7
    place(drums, 0.5, -12 + rng.uniform(-3, 3))

    f0 = rng.choice([41.2, 55.0, 61.7])
    bass = sum((0.5**h) * np.sin(2 * np.pi * f0 * (h + 1) * t) for h in range(3))
    bass *= 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t) ** 2
    place(bass.astype(np.float32), 0.5 + rng.uniform(-0.05, 0.05), -14)

    root = rng.choice([220.0, 246.9, 196.0])
    pad = np.zeros(T, np.float32)
    for ratio in (1.0, 1.25, 1.5):
        for h in range(1, 5):
            pad += (0.3**h) * np.sin(2 * np.pi * root * ratio * h * t + rng.uniform(0, 6.28)).astype(np.float32)
    place(pad, rng.uniform(0.2, 0.8), -18)

    fl = rng.uniform(400, 800)
    lead = np.sin(2 * np.pi * fl * t + 6.0 * np.sin(2 * np.pi * 5.5 * t)).astype(np.float32)
    lead *= np.clip(np.sin(2 * np.pi * 0.25 * t), 0, 1)
    place(lead, 0.5, -16)

    peak = np.abs(out).max()
    return (out / max(peak, 1e-6) * 0.5).astype(np.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("bs", nargs="?", type=int, default=4)
    ap.add_argument("lr", nargs="?", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()
    steps, bs, lr = args.steps, args.bs, args.lr
    dev = resolve_device(args.device)
    use_full_float32()
    print("device:", dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "", flush=True)

    rng = np.random.default_rng(0)
    n_pool = 16
    songs = np.stack([synth_song(rng) for _ in range(n_pool)])  # the training pool
    eval_songs = np.stack([synth_song(rng) for _ in range(4)])  # held out

    torch.manual_seed(0)  # the models' initial weights
    console = AdvancedMixConsole(SR, device=str(dev))
    encoder = SpectrogramEncoder(embed_dim=64, n_fft=2048, hop_length=512, cnn_base_width=8)
    # the heads' input is the two channels' embedding differences: 2 x 64
    projector = ParameterProjector(
        embed_dim=2 * 64, num_tracks=8,
        num_track_control_params=console.num_track_control_params,
        num_fx_bus_control_params=console.num_fx_bus_control_params,
        num_master_bus_control_params=console.num_master_bus_control_params,
    )
    system = ParameterEstimationSystem(encoder, projector, console, remixer=Remixer(SR, separator=hpss_separator),
                                       lr=lr, schedule="none", generator=torch.Generator().manual_seed(0),
                                       device=dev)

    songs_dev = torch.from_numpy(songs).to(dev)  # the pool on the device once; batches gathered there

    # a fixed held-out set, remixed once with a frozen generator: its targets
    # never resample, so the eval trail has low variance
    eval_in = torch.from_numpy(eval_songs).to(dev)
    e_remix, e_tp, e_fp, e_mp = system.remixer(eval_in, console, torch.Generator().manual_seed(1234))

    losses, eval_trail = [], []
    eval_every = max(10, steps // 40)

    def run_eval(step_no):
        m = system.eval_step(eval_in, e_remix, e_tp, e_fp, e_mp)
        rec = {"step": step_no, "loss": round(float(m["loss"]), 4), "track": round(float(m["track_param_loss"]), 4),
               "fx": round(float(m["fx_bus_param_loss"]), 4), "master": round(float(m["master_bus_param_loss"]), 4)}
        eval_trail.append(rec)
        print(f"  eval@{step_no}: {rec}", flush=True)

    run_eval(0)
    batch_gen = torch.Generator().manual_seed(1)
    t0 = time.time()
    for i in range(steps):
        idx = torch.randperm(n_pool, generator=batch_gen)[:bs].to(dev)
        metrics = system.train_step(songs_dev[idx])
        if (i + 1) % 10 == 0:
            losses.append(float(metrics["loss"]))
        if (i + 1) % eval_every == 0:
            print(f"step {i + 1}: train loss {losses[-1]:.4f}", flush=True)
            run_eval(i + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0

    third = max(1, len(losses) // 3)
    first_mean = float(np.mean(losses[:third])) if losses else float("nan")
    last_mean = float(np.mean(losses[-third:])) if losses else float("nan")
    # the constant-0.5 predictor: Var(U(0, 1)) = 1/12 a parameter, group-scaled
    baseline = (27 + 8) / 12.0 + 25 / 12.0 + 26 / 12.0
    e_first, e_last = eval_trail[0]["loss"], eval_trail[-1]["loss"]
    summary = {
        "backend": dev.type,
        "separator": "hpss_separator",
        "steps": steps,
        "batch_size": bs,
        "lr": lr,
        "wall_s": round(wall, 1),
        "loss_trail": [round(x, 4) for x in losses],
        "smoothed_first_third": round(first_mean, 4),
        "smoothed_last_third": round(last_mean, 4),
        "constant_half_baseline": round(baseline, 4),
        "loss_dropped": bool(last_mean < first_mean),
        "below_constant_baseline": bool(last_mean < baseline),
        "heldout_eval_trail": eval_trail,
        "heldout_eval_first": e_first,
        "heldout_eval_last": e_last,
        "heldout_below_constant_baseline": bool(e_last < baseline),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs("logs", exist_ok=True)
    with open("logs/param_est_demo_torch.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
