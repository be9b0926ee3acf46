"""Single-song inference with the PyTorch port (the counterpart of
``scripts/run.py``).

    python scripts/run_torch.py --track_dir DIR --ref REF.wav --output OUT.wav \
        [--ckpt checkpoints/last]

``--ckpt`` takes a checkpoint of ``main_torch.py fit`` or a reference
Lightning ``.ckpt``; without it the model's weights are random, from a
generator seeded 0, with a warning. It runs on the CUDA device unless given
``--device cpu``. The mix is written peak-normalized.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import read_audio, write_audio  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from diffmst_torch.utils.inference import run_diffmst  # noqa: E402
from scripts.eval_all_combo_torch import add_model_args, build_model, model_apply  # noqa: E402


def load_stems(track_dir: str) -> np.ndarray:
    """(1, n, T) mono stems of a directory's wavs, cut to the shortest."""
    stems = []
    for f in sorted(os.listdir(track_dir)):
        if f.endswith(".wav"):
            a, _ = read_audio(os.path.join(track_dir, f))
            stems.append(a.mean(axis=0))
    total = min(s.shape[-1] for s in stems)
    return np.stack([s[:total] for s in stems])[None]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track_dir", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--ckpt", default=None)
    add_model_args(ap)
    ap.add_argument("--render_mode", default="ola", choices=["ola", "streaming"])
    ap.add_argument("--comp_smoother", default="auto")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_full_float32()
    tracks = load_stems(args.track_dir)
    ref, _ = read_audio(args.ref)
    if not args.ckpt:
        print("warning: no --ckpt; using random init")
    model = build_model(args, dev, args.ckpt)
    console = AdvancedMixConsole(44100.0, comp_smoother=args.comp_smoother, device=str(dev))
    mix, *_ = run_diffmst(tracks, ref[None], model_apply(model), console,
                          render_mode=args.render_mode, device=dev)
    write_audio(args.output, mix[0] / max(np.abs(mix).max(), 1e-8), 44100)
    print(f"wrote {args.output}")
    return mix


if __name__ == "__main__":
    main()
