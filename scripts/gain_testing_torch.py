"""Gain-prediction probe with the PyTorch port (the counterpart of
``scripts/gain_testing.py``).

The model mixes a multitrack against each stem in turn as the reference (a
"mix" of that stem alone, in both channels) and the predicted input-fader
gains of every track are printed: a model that attends to the reference
should raise the track that matches it.

    python scripts/gain_testing_torch.py --track_dir DIR [--ckpt checkpoints/last]

Without ``--ckpt`` the weights are random, from a generator seeded 0, with
a warning. It runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import read_audio  # noqa: E402
from diffmst_torch.ops.loudness import integrated_loudness  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from scripts.eval_all_combo_torch import add_model_args, build_model, model_apply  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track_dir", required=True)
    ap.add_argument("--ckpt", default=None)
    add_model_args(ap)
    ap.add_argument("--length", type=int, default=262144)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_full_float32()
    names, stems = [], []
    for f in sorted(os.listdir(args.track_dir)):
        if f.endswith(".wav"):
            a, _ = read_audio(os.path.join(args.track_dir, f), 0, args.length)
            lufs = integrated_loudness(a.T, 44100.0)
            if not np.isfinite(lufs) or lufs < -80:
                continue
            stems.append(a.mean(axis=0) * 10 ** ((-48.0 - lufs) / 20.0))
            names.append(f)
    tracks = np.stack(stems)[None].astype(np.float32)

    if not args.ckpt:
        print("warning: random init")
    apply = model_apply(build_model(args, dev, args.ckpt))
    console = AdvancedMixConsole(44100.0, device=str(dev))

    tracks_dev = torch.from_numpy(tracks).to(dev)
    gains_by_ref = {}
    for i, ref_name in enumerate(names):
        ref = torch.stack([tracks_dev[0, i], tracks_dev[0, i]])[None]  # a one-stem "mix"
        tp, _, _ = apply(tracks_dev, ref)
        gains = console.param_dicts(tp)[0]["input_fader"]["gain_db"][0].cpu().numpy()
        gains_by_ref[ref_name] = dict(zip(names, gains.tolist()))
        print(f"reference = {ref_name}:")
        for n, g in zip(names, gains):
            print(f"  {n}: {g:+.1f} dB")
    return gains_by_ref


if __name__ == "__main__":
    main()
