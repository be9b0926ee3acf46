"""Listening-test audio with the PyTorch port (the counterpart of
``scripts/eval_listen.py``).

For each song, each section is rendered by the model against the reference
normalized to each of a sweep of loudness levels, one wav per (section,
level). Every level reuses the song cached on the device
(``utils/inference.py::_device_tracks``).

    python scripts/eval_listen_torch.py --examples_dir DIR --output_dir OUT \
        --ckpt checkpoints/last [--levels -24 -18 -12 -6]

It runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import write_audio  # noqa: E402
from diffmst_torch.ops.loudness import loudness_normalize  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from diffmst_torch.utils.inference import run_diffmst  # noqa: E402
from scripts.eval_all_combo_torch import add_model_args, build_model, load_song, model_apply  # noqa: E402

SR = 44100


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--levels", type=float, nargs="+", default=[-24.0, -18.0, -12.0, -6.0])
    add_model_args(ap)
    ap.add_argument("--sections", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_full_float32()
    apply = model_apply(build_model(args, dev, args.ckpt))
    console = AdvancedMixConsole(float(SR), device=str(dev))

    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    for song in sorted(os.listdir(args.examples_dir)):
        song_dir = os.path.join(args.examples_dir, song)
        if not os.path.isdir(song_dir):
            continue
        tracks, ref = load_song(song_dir)
        for sec in args.sections:
            for level in args.levels:
                ref_leveled = loudness_normalize(np.asarray(ref[0]).T, SR, level).T[None]
                mix, *_ = run_diffmst(
                    tracks, ref_leveled.astype(np.float32), apply, console,
                    track_start_idx=sec, ref_start_idx=sec, device=dev,
                )
                out = os.path.join(args.output_dir, song, f"sec{sec}_ref{int(level)}lufs.wav")
                write_audio(out, mix[0] / max(np.abs(mix).max(), 1e-8), SR)
                written.append(out)
                print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()
