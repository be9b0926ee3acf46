"""Dataset channel-count census, with the PyTorch port's WAV reader.

The counterpart of ``scripts/info.py``: count the WAV files under a root by
channel count and sum their length. It reads headers on the host and
touches no tensor, so it takes no ``--device``.

    python3 scripts/info_torch.py --root DIR
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.data import audio_info  # noqa: E402


def census(root: str):
    """(Counter of "<n>ch" and "unreadable", total seconds) under ``root``."""
    counts = collections.Counter()
    seconds = 0.0
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".wav"):
                continue
            try:
                frames, chs, sr = audio_info(os.path.join(dirpath, f))
            except Exception:  # noqa: BLE001 -- any unreadable file is counted, as info.py does
                counts["unreadable"] += 1
                continue
            counts[f"{chs}ch"] += 1
            seconds += frames / sr
    return counts, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args(argv)

    counts, seconds = census(args.root)
    for k, v in sorted(counts.items()):
        print(f"{k}: {v}")
    print(f"total audio: {seconds / 3600:.2f} h")
    return counts, seconds


if __name__ == "__main__":
    main()
