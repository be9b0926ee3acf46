"""Compare two mixes by their audio features (Bark spectra and scalar stats).

The PyTorch port's counterpart of ``scripts/compare.py``: load two stereo
mixes, compute the five ``AudioFeatureLoss`` features (Bark spectrum, crest
factor, RMS, stereo imbalance, stereo width) with
``diffmst_torch.losses.features``, plot the mid/side Bark spectra of A
against B, and write the scalar features to a CSV. The features are
computed on the CUDA device, or on the CPU with ``--device cpu``.

    python3 scripts/compare_torch.py a.wav b.wav [--output_dir outputs/compare] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.data import read_audio  # noqa: E402
from diffmst_torch.losses import features as F  # noqa: E402
from diffmst_torch.utils.device import resolve_device  # noqa: E402


def _load_stereo(path: str) -> tuple[np.ndarray, int]:
    """(1, 2, T) float32 batch from a mono or stereo WAV (mono duplicated)."""
    audio, sr = read_audio(path)
    if audio.shape[0] == 1:
        audio = np.concatenate([audio, audio], axis=0)
    return audio[None, :2], sr


def compare_mixes(input_a: str, input_b: str, sample_rate: int = 44100, device=None) -> dict:
    """The five features of both mixes, computed on ``device`` (None: the
    CUDA device).

    Returns {"a": {...}, "b": {...}}, each with the scalar features (floats
    and per-channel lists), the (n_bands, 2) mid-side Bark spectrum as a
    NumPy array and the file's sample rate.
    """
    dev = resolve_device(device)
    out = {}
    for name, path in (("a", input_a), ("b", input_b)):
        audio, sr = _load_stereo(path)
        x = torch.from_numpy(audio).to(dev)
        out[name] = {
            "barkspectrum": F.compute_barkspectrum(x, sample_rate=sample_rate)[0].cpu().numpy(),
            "crest_factor": F.compute_crest_factor(x)[0].cpu().tolist(),
            "rms": F.compute_rms(x)[0].cpu().tolist(),
            "stereo_imbalance": float(F.compute_stereo_imbalance(x)[0]),
            "stereo_width": float(F.compute_stereo_width(x)[0]),
            "file_sample_rate": sr,
        }
    return out


def plot_barkspectra(feats: dict, out_path: str) -> bool:
    """Mid and side Bark spectra of A and B, one above the other. Returns
    False, writing nothing, where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, axs = plt.subplots(2, 1, sharex=True, sharey=True)
    a, b = feats["a"]["barkspectrum"], feats["b"]["barkspectrum"]
    axs[0].plot(a[:, 0], label="A-mid", color="tab:orange")
    axs[0].plot(b[:, 0], label="B-mid", color="tab:blue")
    axs[1].plot(a[:, 1], label="A-side", color="tab:orange")
    axs[1].plot(b[:, 1], label="B-side", color="tab:blue")
    axs[0].set_ylabel("log bark magnitude (mid)")
    axs[1].set_ylabel("log bark magnitude (side)")
    axs[1].set_xlabel("bark band")
    axs[0].legend()
    axs[1].legend()
    fig.savefig(out_path)
    plt.close(fig)
    return True


def write_feature_csv(feats: dict, out_path: str) -> None:
    """Scalar features of both mixes, one row per (feature, mix)."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["feature", "mix", "value"])
        for name in ("a", "b"):
            fe = feats[name]
            w.writerow(["rms_l", name, fe["rms"][0]])
            w.writerow(["rms_r", name, fe["rms"][1]])
            w.writerow(["crest_factor_l", name, fe["crest_factor"][0]])
            w.writerow(["crest_factor_r", name, fe["crest_factor"][1]])
            w.writerow(["stereo_width", name, fe["stereo_width"]])
            w.writerow(["stereo_imbalance", name, fe["stereo_imbalance"]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input_a", type=str)
    ap.add_argument("input_b", type=str)
    ap.add_argument("--output_dir", type=str, default="outputs/compare")
    ap.add_argument("--sample_rate", type=int, default=44100)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    a_name = os.path.basename(args.input_a).split(".")[0]
    b_name = os.path.basename(args.input_b).split(".")[0]
    output_dir = os.path.join(args.output_dir, f"{a_name}-{b_name}")
    os.makedirs(output_dir, exist_ok=True)

    feats = compare_mixes(args.input_a, args.input_b, args.sample_rate, device=args.device)

    csv_path = os.path.join(output_dir, "features.csv")
    write_feature_csv(feats, csv_path)
    plotted = plot_barkspectra(feats, os.path.join(output_dir, "bark_spectrum.png"))

    for name in ("a", "b"):
        fe = feats[name]
        print(
            f"{name}: rms={fe['rms']} crest={fe['crest_factor']} "
            f"width={fe['stereo_width']:.4f} imbalance={fe['stereo_imbalance']:.4f}"
        )
    print(f"wrote {csv_path}" + ("" if plotted else " (no matplotlib: plot skipped)"))
    return output_dir


if __name__ == "__main__":
    main()
