"""Generate a flagship-scale synthetic WAV corpus + metadata YAML, with the PyTorch port.

The counterpart of ``scripts/make_synth_corpus.py`` for machines without
JAX: the same corpus, byte for byte, written through
``diffmst_torch.data.write_audio``.

Produces the on-disk shape the real data pipeline consumes (the reference
trains from per-song stem directories listed in data/*.yaml metadata):
N songs x M stems (one stereo
stem per song to exercise the stereo->2xmono split), 16-bit PCM WAV at
44.1 kHz, loud enough to clear the -48 LUFS gate. Content is banded noise +
tone stacks with slow envelopes — spectrally diverse so encoder inputs and
LUFS measurements are not degenerate.

Usage:
    python scripts/make_synth_corpus_torch.py [root] [n_train_songs] [n_val_songs] [seconds]

Defaults: /tmp/diffmst_synth_corpus, 10 train + 2 val songs, 12 s stems.
Writes <root>/meta.yaml; point MultitrackDataModule's track_root_dirs at
<root> and metadata_files at <root>/meta.yaml.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import yaml
from scipy.signal import lfilter

from diffmst_torch.data import write_audio

SR = 44100

INSTRUMENTS = [
    "kick", "snare", "bass", "vocals", "electric guitar",
    "acoustic guitar", "piano", "synth", "strings",
]


def _stem(rng: np.random.Generator, n: int, kind: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / SR
    if kind % 3 == 0:  # banded noise (drums/percussion-ish)
        x = rng.normal(size=n).astype(np.float32)
        # one-pole band shaping: two cascaded leaky integrators at a random rate
        a = float(rng.uniform(0.6, 0.995))
        for _ in range(2):
            x = lfilter([1.0 - a], [1.0, -a], x).astype(np.float32)
    elif kind % 3 == 1:  # tone stack (harmonic instruments)
        f0 = float(rng.uniform(60.0, 800.0))
        x = np.zeros(n, np.float32)
        for h in range(1, 6):
            x += float(rng.uniform(0.2, 1.0)) / h * np.sin(
                2 * np.pi * f0 * h * t + float(rng.uniform(0, 2 * np.pi))
            ).astype(np.float32)
    else:  # noise bursts (transients)
        x = rng.normal(size=n).astype(np.float32)
        gate = (rng.random(size=n // 4096 + 1) > 0.5).astype(np.float32)
        x *= np.repeat(gate, 4096)[:n]
    # slow amplitude envelope so integrated loudness varies across offsets
    env_pts = rng.uniform(0.3, 1.0, size=8).astype(np.float32)
    env = np.interp(np.linspace(0, 7, n), np.arange(8), env_pts).astype(np.float32)
    x *= env
    peak_db = float(rng.uniform(-18.0, -6.0))
    x *= 10 ** (peak_db / 20.0) / max(1e-9, np.abs(x).max())
    return x


def make_corpus(root: str, n_train: int = 10, n_val: int = 2,
                seconds: float = 12.0, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    meta = {"train": {}, "val": {}}
    for split, count in (("train", n_train), ("val", n_val)):
        for s in range(count):
            song = f"{split}_song{s:02d}"
            n = int(seconds * SR * float(rng.uniform(0.9, 1.2)))
            tracks = {}
            for i, inst in enumerate(INSTRUMENTS):
                name = f"{inst.replace(' ', '_')}.wav"
                write_audio(
                    os.path.join(root, song, name), _stem(rng, n, i)[None], SR
                )
                tracks[name] = inst
            # one stereo stem -> split into two mono tracks by the loader
            st = np.stack([_stem(rng, n, 1), _stem(rng, n, 1)])
            write_audio(os.path.join(root, song, "keys_st.wav"), st, SR)
            tracks["keys_st.wav"] = "piano"
            meta[split][song] = tracks
    meta_path = os.path.join(root, "meta.yaml")
    with open(meta_path, "w") as f:
        yaml.safe_dump(meta, f)
    return meta_path


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/diffmst_synth_corpus"
    n_train = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    n_val = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    seconds = float(sys.argv[4]) if len(sys.argv) > 4 else 12.0
    meta = make_corpus(root, n_train, n_val, seconds)
    total = sum(
        os.path.getsize(os.path.join(d, f))
        for d, _, fs in os.walk(root) for f in fs
    )
    print(f"corpus at {root} ({total / 1e6:.0f} MB), metadata {meta}")
