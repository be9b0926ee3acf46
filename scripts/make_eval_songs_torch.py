"""Held-out eval songs for ``scripts/eval_all_combo_torch.py``, made with the
PyTorch port (the counterpart of ``scripts/make_eval_songs.py``).

Each song is colored-noise stems (white noise through a random one-pole,
peak-staged at -48 dB) and a reference mix rendered by the
``AdvancedMixConsole`` with uniformly random parameters under the training
flags (EQ, compressor and master bus on; fx bus and faders off), then
peak-normalized. Song i draws from a ``torch.Generator`` seeded 3000 + i:
the layout, the levels and the normalization are the JAX script's, the
draws are not (a JAX key and a torch generator give different numbers).

Layout written (the reference's eval layout):
    OUT/song_XX/tracks/stem_YY.wav
    OUT/song_XX/ref.wav

    python scripts/make_eval_songs_torch.py [--out data/eval_songs] [--n 4] \
        [--t 1048576] [--device cpu]

It runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import write_audio  # noqa: E402
from diffmst_torch.mixing import naive_random_mix  # noqa: E402
from diffmst_torch.utils.audio import batch_stereo_peak_normalize  # noqa: E402
from diffmst_torch.utils.device import resolve_device  # noqa: E402

SR = 44100
NT = 8


def synth_tracks(generator: torch.Generator, n_tracks: int, t: int, device) -> torch.Tensor:
    """(1, n_tracks, t) float32 stems: white noise through a one-pole of a
    uniform (0, 0.95) pole, each peak at -48 dBFS (the JAX script's recipe;
    the noise and then the poles drawn from ``generator``)."""
    x = torch.randn((1, n_tracks, t), generator=generator).to(device)
    a = (0.95 * torch.rand((1, n_tracks, 1), generator=generator)).to(device)
    phase = torch.exp(-2j * math.pi * torch.fft.rfftfreq(t, device=device)).to(torch.complex64)
    h = (1.0 - a) / (1.0 - a * phase)
    x = torch.fft.irfft(torch.fft.rfft(x, dim=-1) * h, n=t, dim=-1)
    peak = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return x / torch.clamp(peak, min=1e-9) * 10 ** (-48 / 20)


@torch.no_grad()
def make_song(seed: int, t: int, console, device):
    """(tracks (1, NT, t), reference (1, 2, t)) on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    tracks = synth_tracks(gen, NT, t, device)
    ref = naive_random_mix(
        tracks, console, gen,
        use_track_input_fader=False, use_track_eq=True, use_track_compressor=True,
        use_fx_bus=False, use_master_bus=True, use_output_fader=False,
    )
    return tracks, batch_stereo_peak_normalize(ref.mix)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/eval_songs")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--t", type=int, default=2**20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    console = AdvancedMixConsole(float(SR), device=str(dev))
    dirs = []
    for i in range(args.n):
        tracks, ref = make_song(3000 + i, args.t, console, dev)
        tracks, ref = tracks.cpu().numpy(), ref.cpu().numpy()
        song_dir = os.path.join(args.out, f"song_{i:02d}")
        tdir = os.path.join(song_dir, "tracks")
        os.makedirs(tdir, exist_ok=True)
        for j in range(NT):
            write_audio(os.path.join(tdir, f"stem_{j:02d}.wav"), np.stack([tracks[0, j], tracks[0, j]]), SR)
        write_audio(os.path.join(song_dir, "ref.wav"), ref[0], SR)
        dirs.append(song_dir)
        print(f"wrote {song_dir} ({NT} stems + ref, {args.t} samples)", flush=True)
    return dirs


if __name__ == "__main__":
    main()
