"""Supervised training demo for the PyTorch port's ``UNetSeparator``.

The counterpart of ``scripts/unet_separator_demo.py``: supervised mask
learning on synthetic 4-stem songs (drums, bass, other, vocals, in
HDemucs' stem order), the same songs from the same NumPy seed. The
separator's softmax masks make its stems sum to the mix, as the synthetic
stems do, so the task is well posed. The metric is the mean SI-SDR a stem
on held-out songs, against two separators that need no training
(``band_split_separator`` and ``hpss_separator``) and the untrained U-Net.
The U-Net trains with ``torch.optim.Adam`` (JAX's demo: optax's adam) on
an L1 loss; its initial weights are PyTorch's, from ``torch.manual_seed(0)``.

Writes logs/unet_separator_demo_torch.json under the working directory.
Runs on the CUDA device, or on the CPU with ``--device cpu``:

    python3 scripts/unet_separator_demo_torch.py [steps] [bs] [lr] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.losses.eval_metrics import si_sdr  # noqa: E402
from diffmst_torch.models.separator import UNetSeparator, hpss_separator  # noqa: E402
from diffmst_torch.train.param_system import band_split_separator  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

SR = 44100.0
T = 512 * 128  # 65,536 samples, about 1.5 s


def synth_stems(rng: np.random.Generator) -> np.ndarray:
    """One song as 4 stereo stems (4, 2, T): drums, bass, other, vocals
    (``scripts/unet_separator_demo.py``'s, draw for draw)."""
    t = np.arange(T) / SR
    stems = np.zeros((4, 2, T), np.float32)

    def place(idx, sig, pan, level_db):
        g = 10.0 ** (level_db / 20.0)
        theta = pan * np.pi / 2.0
        stems[idx, 0] += np.float32(g * np.cos(theta)) * sig
        stems[idx, 1] += np.float32(g * np.sin(theta)) * sig

    drums = np.zeros(T, np.float32)
    period = int(0.5 * SR)
    for k in range(0, T, period):
        n = min(4096, T - k)
        env = np.exp(-np.arange(n) / (0.02 * SR))
        drums[k: k + n] += env * np.sin(2 * np.pi * 55 * t[:n]) * 2.0
        s = k + period // 2
        if s + n < T:
            drums[s: s + n] += env * rng.normal(size=n).astype(np.float32) * 0.7
    place(0, drums, 0.5, -12 + rng.uniform(-3, 3))

    f0 = rng.choice([41.2, 55.0, 61.7])
    bass = sum((0.5**h) * np.sin(2 * np.pi * f0 * (h + 1) * t) for h in range(3))
    bass *= 0.5 + 0.5 * np.sin(2 * np.pi * 0.5 * t) ** 2
    place(1, bass.astype(np.float32), 0.5 + rng.uniform(-0.05, 0.05), -14)

    root = rng.choice([220.0, 246.9, 196.0])
    pad = np.zeros(T, np.float32)
    for ratio in (1.0, 1.25, 1.5):
        for h in range(1, 5):
            pad += (0.3**h) * np.sin(2 * np.pi * root * ratio * h * t + rng.uniform(0, 6.28)).astype(np.float32)
    place(2, pad, rng.uniform(0.2, 0.8), -18)

    fl = rng.uniform(400, 800)
    lead = np.sin(2 * np.pi * fl * t + 6.0 * np.sin(2 * np.pi * 5.5 * t)).astype(np.float32)
    lead *= np.clip(np.sin(2 * np.pi * 0.25 * t), 0, 1)
    place(3, lead, 0.5, -16)

    peak = np.abs(stems.sum(axis=0)).max()
    return stems / max(peak, 1e-6) * 0.5


@torch.no_grad()
def heldout_sisdr(sep_fn, mixes: torch.Tensor, stems: torch.Tensor) -> float:
    """Mean SI-SDR (dB) over the active (song, stem, channel) rows: rows
    whose stem is silent are left out, as JAX's demo masks them."""
    out = sep_fn(mixes)  # (bs, 4, 2, T)
    pred = out.reshape(-1, out.shape[-1])
    target = stems.reshape(-1, stems.shape[-1])
    active = target.abs().amax(dim=-1) > 1e-6
    if not bool(active.any()):
        return 0.0
    return float(si_sdr(pred[active], target[active]))  # si_sdr averages over the rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("bs", nargs="?", type=int, default=4)
    ap.add_argument("lr", nargs="?", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    steps, bs, lr = args.steps, args.bs, args.lr
    dev = resolve_device(args.device)
    use_full_float32()
    print("device:", dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "", flush=True)

    rng = np.random.default_rng(7)
    n_pool = 16
    pool = np.stack([synth_stems(rng) for _ in range(n_pool)])  # (16, 4, 2, T)
    evals = np.stack([synth_stems(rng) for _ in range(4)])

    pool_dev = torch.from_numpy(pool).to(dev)
    eval_stems = torch.from_numpy(evals).to(dev)
    eval_mixes = eval_stems.sum(dim=1)  # (4, 2, T)

    torch.manual_seed(0)  # the U-Net's initial weights
    model = UNetSeparator().to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def train_step(stems):
        sep = model(stems.sum(dim=1))
        loss = torch.mean(torch.abs(sep - stems))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    baselines = {
        "band_split": heldout_sisdr(band_split_separator, eval_mixes, eval_stems),
        "hpss": heldout_sisdr(hpss_separator, eval_mixes, eval_stems),
        "unet_init": heldout_sisdr(model, eval_mixes, eval_stems),
    }
    print("held-out SI-SDR baselines:", baselines, flush=True)

    batch_gen = torch.Generator().manual_seed(1)
    trail, losses = [], []
    eval_every = max(50, steps // 20)
    t0 = time.time()
    for i in range(steps):
        idx = torch.randperm(n_pool, generator=batch_gen)[:bs].to(dev)
        loss = train_step(pool_dev[idx])
        if (i + 1) % 50 == 0:
            losses.append(round(float(loss), 5))
        if (i + 1) % eval_every == 0:
            sdr = heldout_sisdr(model, eval_mixes, eval_stems)
            trail.append({"step": i + 1, "heldout_sisdr_db": round(sdr, 3)})
            print(f"step {i + 1}: train L1 {float(loss):.5f}  held-out SI-SDR {sdr:.2f} dB", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0

    final = trail[-1]["heldout_sisdr_db"] if trail else baselines["unet_init"]
    summary = {
        "backend": dev.type,
        "steps": steps,
        "batch_size": bs,
        "lr": lr,
        "wall_s": round(wall, 1),
        "heldout_sisdr_baselines_db": {k: round(v, 3) for k, v in baselines.items()},
        "heldout_sisdr_trained_db": final,
        "train_l1_trail": losses,
        "heldout_sisdr_trail": trail,
        "beats_init": bool(final > baselines["unet_init"]),
        "beats_band_split": bool(final > baselines["band_split"]),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs("logs", exist_ok=True)
    with open("logs/unet_separator_demo_torch.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
