"""Ablated-reference evaluation with the PyTorch port (the counterpart of
``scripts/eval_ablation.py``).

The model mixes each song against degraded references (mono-folded,
band-limited below 4 kHz, 12 dB quieter) and the full one; a CSV gets the
features of each mix: how much each attribute of the reference drives the
predicted mix.

    python scripts/eval_ablation_torch.py --examples_dir DIR --output_dir OUT \
        --ckpt checkpoints/last

It runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import write_audio  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from diffmst_torch.utils.inference import run_diffmst  # noqa: E402
from scripts.eval_all_combo_torch import (  # noqa: E402
    add_model_args,
    build_model,
    load_song,
    mix_features,
    model_apply,
)

SR = 44100


def ablations(ref: np.ndarray) -> dict:
    """The reference and its degraded versions, by name (JAX's)."""
    out = {"full": ref}
    mono = ref.mean(axis=1, keepdims=True)
    out["mono"] = np.repeat(mono, 2, axis=1)
    out["quiet"] = ref * 10 ** (-12 / 20)
    # band-limit below 4 kHz with an FFT brickwall
    X = np.fft.rfft(ref, axis=-1)
    freqs = np.fft.rfftfreq(ref.shape[-1], 1 / SR)
    X[..., freqs > 4000] = 0
    out["lowpassed"] = np.fft.irfft(X, n=ref.shape[-1], axis=-1).astype(np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--ckpt", required=True)
    add_model_args(ap)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_full_float32()
    apply = model_apply(build_model(args, dev, args.ckpt))
    console = AdvancedMixConsole(float(SR), device=str(dev))

    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    for song in sorted(os.listdir(args.examples_dir)):
        song_dir = os.path.join(args.examples_dir, song)
        if not os.path.isdir(song_dir):
            continue
        tracks, ref = load_song(song_dir)
        for name, aref in ablations(ref).items():
            mix, *_ = run_diffmst(tracks, aref.astype(np.float32), apply, console, device=dev)
            write_audio(os.path.join(args.output_dir, f"{song}_{name}.wav"),
                        mix[0] / max(np.abs(mix).max(), 1e-8), SR)
            row = {"song": song, "ablation": name}
            row.update({f"mix_{k}": v for k, v in mix_features(mix, dev).items()})
            rows.append(row)
            print(row, flush=True)

    with open(os.path.join(args.output_dir, "ablation.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()
