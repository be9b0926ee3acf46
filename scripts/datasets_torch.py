"""Offline dataset preprocessing: stereo to per-channel mono, resampled.

The PyTorch port's counterpart of ``scripts/datasets.py``: walk a dataset
root, split multichannel WAVs into L/R mono files and resample them to the
target rate by polyphase resampling (``scipy.signal.resample_poly``), with
the port's WAV reader and writer. It runs on the host and touches no
tensor, so it takes no ``--device``.

    python3 scripts/datasets_torch.py --input_dir IN --output_dir OUT [--sr 44100]
"""

from __future__ import annotations

import argparse
import os
import sys
from math import gcd

import numpy as np
from scipy import signal as sps

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.data import read_audio, write_audio  # noqa: E402


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """``x`` (channels, frames) from ``sr_in`` to ``sr_out``, float32."""
    if sr_in == sr_out:
        return x
    g = gcd(sr_in, sr_out)
    return sps.resample_poly(x, sr_out // g, sr_in // g, axis=-1).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--sr", type=int, default=44100)
    args = ap.parse_args(argv)

    n = 0
    for dirpath, _dirs, files in os.walk(args.input_dir):
        for f in files:
            if not f.endswith(".wav"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), args.input_dir)
            try:
                audio, sr = read_audio(os.path.join(dirpath, f))
            except (OSError, ValueError) as e:
                print(f"skip {rel}: {e}")
                continue
            audio = resample(audio, sr, args.sr)
            base = os.path.join(args.output_dir, rel[:-4])
            if audio.shape[0] == 1:
                write_audio(base + ".wav", audio, args.sr)
                n += 1
            else:
                for ch, tag in zip(range(audio.shape[0]), "LRCS"):
                    write_audio(f"{base}_{tag}.wav", audio[ch : ch + 1], args.sr)
                    n += 1
    print(f"wrote {n} mono files to {args.output_dir}")
    return n


if __name__ == "__main__":
    main()
