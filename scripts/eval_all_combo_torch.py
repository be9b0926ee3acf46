"""Primary evaluation entry of the PyTorch port: section cross-product evaluation.

The counterpart of ``scripts/eval_all_combo.py`` (the reference's
documented eval command): for each example song, every combination of
track section x reference section goes through the model (and an
equal-loudness sum baseline); the mixes are loudness-normalized to -22 LUFS
and written as wavs, and a CSV gets each mix's features (``losses/
features.py``), the reference's, and the mix's MRSTFT distance and SI-SDR
to the reference. The CSV's columns are the JAX script's.

Layout: ``--examples_dir`` holds one directory per song, each with a
``tracks/`` directory of stem wavs and a ``ref.wav``
(``scripts/make_eval_songs_torch.py`` writes one).

    python scripts/eval_all_combo_torch.py --examples_dir DIR --output_dir OUT \
        --ckpt checkpoints/last [--section_len 441000] [--num_sections 2]

``--ckpt`` takes a checkpoint of ``main_torch.py fit`` or a reference
Lightning ``.ckpt``; without it only the sum baseline is evaluated. It runs
on the CUDA device unless given ``--device cpu``. ``scripts/summarize_eval.py``
reads the CSV as it is.
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.data import read_audio, write_audio  # noqa: E402
from diffmst_torch.losses import features as F  # noqa: E402
from diffmst_torch.losses.eval_metrics import mrstft_distance, si_sdr  # noqa: E402
from diffmst_torch.ops.loudness import integrated_loudness, loudness_normalize  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from diffmst_torch.utils.inference import run_diffmst  # noqa: E402

SR = 44100


def add_model_args(ap: argparse.ArgumentParser) -> None:
    """The model's widths and ``--device``, as every script with a model
    takes them."""
    ap.add_argument("--embed_dim", type=int, default=512)
    ap.add_argument("--num_layers", type=int, default=12)
    ap.add_argument("--cnn_base_width", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")


def build_model(args, device, ckpt=None):
    """A ``MixStyleTransferModel`` of ``args``' widths on ``device`` in eval
    mode, with the weights of ``ckpt`` (a ``main_torch.py fit`` checkpoint
    or a reference Lightning ``.ckpt``), else seeded random ones."""
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.utils.checkpoint import load_reference_checkpoint, restore_model

    model = MixStyleTransferModel.build(
        embed_dim=args.embed_dim, num_layers=args.num_layers,
        cnn_base_width=args.cnn_base_width, device=device,
    )
    if ckpt and ckpt.endswith(".ckpt"):
        load_reference_checkpoint(ckpt, model)
    elif ckpt:
        restore_model(ckpt, model)
    return model.eval()


def model_apply(model):
    """(tracks, ref) -> the model's parameters, without autograd."""

    @torch.no_grad()
    def apply(t, r):
        return model(t, r)

    return apply


def load_song(song_dir: str):
    """((1, n, T) mono stems cut to the shortest, (1, 2, T_ref) reference)."""
    stems = []
    tdir = os.path.join(song_dir, "tracks")
    for f in sorted(os.listdir(tdir)):
        if f.endswith(".wav"):
            a, _ = read_audio(os.path.join(tdir, f))
            stems.append(a.mean(axis=0))
    total = min(s.shape[-1] for s in stems)
    tracks = np.stack([s[:total] for s in stems])[None]
    ref, _ = read_audio(os.path.join(song_dir, "ref.wav"))
    return tracks, ref[None]


def equal_loudness_sum(tracks: np.ndarray) -> np.ndarray:
    """The reference's baseline: the stems at -48 LUFS each (those under
    -80 LUFS left out), summed into both channels."""
    out = np.zeros((1, 2, tracks.shape[-1]), np.float32)
    for i in range(tracks.shape[1]):
        lufs = integrated_loudness(tracks[0, i], SR)
        if not np.isfinite(lufs) or lufs < -80:
            continue
        g = 10 ** ((-48.0 - lufs) / 20.0)
        out[0, 0] += tracks[0, i] * g
        out[0, 1] += tracks[0, i] * g
    return out


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


def mix_features(mix: np.ndarray, device="cpu") -> dict:
    """The mean of each feature of a (1, 2, T) host mix, computed in float32
    on ``device``."""
    x = _tensor(mix, device)
    return {
        "rms": float(torch.mean(F.compute_rms(x))),
        "crest_factor": float(torch.mean(F.compute_crest_factor(x))),
        "stereo_width": float(torch.mean(F.compute_stereo_width(x))),
        "stereo_imbalance": float(torch.mean(F.compute_stereo_imbalance(x))),
        "barkspectrum_mean": float(torch.mean(F.compute_barkspectrum(x, sample_rate=SR))),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="a main_torch.py fit checkpoint or a reference Lightning .ckpt")
    add_model_args(ap)
    ap.add_argument("--section_len", type=int, default=441000)
    ap.add_argument("--num_sections", type=int, default=2)
    ap.add_argument("--output_lufs", type=float, default=-22.0)
    ap.add_argument("--render_mode", default="ola", choices=["ola", "streaming"],
                    help="'streaming' = seam-free overlap-save rendering")
    ap.add_argument("--comp_smoother", default="auto",
                    help="console compressor smoother (auto/fsm/scan/decoupled)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    use_full_float32()
    console = AdvancedMixConsole(float(SR), comp_smoother=args.comp_smoother, device=str(dev))
    apply = model_apply(build_model(args, dev, args.ckpt)) if args.ckpt else None

    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    for song in sorted(os.listdir(args.examples_dir)):
        song_dir = os.path.join(args.examples_dir, song)
        if not os.path.isdir(song_dir):
            continue
        tracks, ref = load_song(song_dir)
        total = tracks.shape[-1]
        sections = [
            i * args.section_len
            for i in range(args.num_sections)
            if (i + 1) * args.section_len <= total
        ] or [0]
        ref_sections = [
            i * args.section_len
            for i in range(args.num_sections)
            if (i + 1) * args.section_len <= ref.shape[-1]
        ] or [0]
        ref_feats = mix_features(ref, dev)
        baseline = equal_loudness_sum(tracks)  # the same for every combination

        for ti, ri in itertools.product(sections, ref_sections):
            methods = {"sum": baseline}
            if apply is not None:
                mix, *_ = run_diffmst(
                    tracks, ref, apply, console,
                    track_start_idx=ti, ref_start_idx=ri,
                    render_mode=args.render_mode, device=dev,
                )
                methods["diffmst"] = mix
            for method, mix in methods.items():
                mix = loudness_normalize(np.asarray(mix[0]).T, SR, args.output_lufs).T[None]
                name = f"{song}_t{ti}_r{ri}_{method}"
                write_audio(os.path.join(args.output_dir, name + ".wav"), mix[0], SR)
                feats = mix_features(mix, dev)
                row = {"song": song, "method": method, "track_start": ti, "ref_start": ri}
                row.update({f"mix_{k}": v for k, v in feats.items()})
                row.update({f"ref_{k}": v for k, v in ref_feats.items()})
                # style-transfer distances to the reference mix
                n = min(mix.shape[-1], ref.shape[-1])
                pred_t, ref_t = _tensor(mix[..., :n], dev), _tensor(ref[..., :n], dev)
                row["mrstft_to_ref"] = float(mrstft_distance(pred_t, ref_t))
                row["sisdr_to_ref"] = float(si_sdr(pred_t, ref_t))
                rows.append(row)
                print(f"{name}: {feats}", flush=True)

    csv_path = os.path.join(args.output_dir, "results.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {csv_path} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
