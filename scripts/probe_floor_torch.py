"""Oracle floor of the train demo's probe curve, on the PyTorch port.

The port's counterpart of ``scripts/probe_floor_tpu.py``: the loss of the
ORACLE parameters, the normalized parameters that drew each probe reference
mix (the Trainer's deterministic validation draws,
``train_demo_torch.probe_params``), rendered as the validation renders the
model's prediction:

  * the validation renders the SECOND HALF of the stems only (the reference
    mix was rendered whole and cropped, so the compressor's state and the
    EQ's FFT block edges differ at the crop);
  * the reference mix is peak-normalized per batch item and the prediction
    is not, so the oracle expresses the 1/peak gain through the master
    output fader (slot 24 of the master bus); the needed dB is reported, to
    show whether it fits the fader's +/-48 dB;
  * the reference has no track input fader and no output fader, so the
    oracle sets the track fader (slot 0) to normalized 0.5 (0 dB).

Three floors, each the mean over the probe batches:

  * ``floor_half_render``: the half render, the fader at the exact gain even
    beyond its range (the construction's floor, crop effect included);
  * ``floor_half_render_clipped``: the same with the fader clipped to +/-48
    dB, the floor of a parameter vector the controller can emit;
  * ``floor_full_render_crop``: the whole render, scaled, then cropped:
    numerical noise only (about 0); its gap to the first is the crop effect.

Writes logs/probe_floor_torch.json under the working directory. Runs on the
CUDA device, or on the CPU with ``--device cpu`` (``DEMO_DEVICE``; ``--toy``:
one probe batch of 2 x 2 x 8,192 samples):

    python3 scripts/probe_floor_torch.py [--device cpu] [--toy]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.console.ranges import normalize  # noqa: E402
from diffmst_torch.losses import MultiResolutionSTFTLoss  # noqa: E402
from diffmst_torch.mixing import naive_random_mix  # noqa: E402
from diffmst_torch.utils.audio import batch_stereo_peak_normalize  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402

from train_demo_torch import (FLAGS, SR, SyntheticDM, card, parse, probe_baseline, probe_params,  # noqa: E402
                              toy_probe)

OUTPUT_FADER = 24  # the master bus's output fader slot (console/ranges.py::split_master_bus_params)
TRACK_FADER = 0  # the track's input fader slot


@torch.no_grad()
def floors(tracks: torch.Tensor, console, loss_fn, params):
    """(half-render floor, clipped floor, full-render-crop floor, the
    output fader's needed dB a batch item) of one probe batch whose
    reference mix drew ``params`` (track, fx bus, master bus)."""
    ref = naive_random_mix(tracks, console, None, use_track_input_fader=False, use_output_fader=False,
                           params=params, **FLAGS)
    peak = torch.amax(torch.abs(ref.mix), dim=(-2, -1))  # (bs,)
    middle = tracks.shape[-1] // 2
    ref_b = batch_stereo_peak_normalize(ref.mix)[..., middle:]

    # the oracle: the drawn parameters, the track fader at 0 dB, the output
    # fader expressing the 1/peak normalization
    need_db = -20.0 * torch.log10(torch.clamp(peak, min=1e-8))
    track, fx, master = params
    track = track.clone()
    track[..., TRACK_FADER] = 0.5
    exact, clipped = master.clone(), master.clone()
    exact[..., OUTPUT_FADER] = normalize(need_db, -48.0, 48.0)
    clipped[..., OUTPUT_FADER] = normalize(torch.clamp(need_db, -48.0, 48.0), -48.0, 48.0)

    def render(x, m):
        return console(x, track, fx, m, use_track_input_fader=True, use_output_fader=True, **FLAGS).mix

    half = loss_fn(render(tracks[..., middle:], exact), ref_b)
    half_clipped = loss_fn(render(tracks[..., middle:], clipped), ref_b)
    full = loss_fn(render(tracks, exact)[..., middle:], ref_b)
    return float(half), float(half_clipped), float(full), need_db


def probe_floors(dm, console, loss_fn, n_probe: int, params=None) -> dict:
    """The floors of every probe batch (its validation draws, or
    ``params[i]``), their means, the baseline and the needed dB."""
    rows, exact = [], []
    for i in range(n_probe):
        t0 = time.time()
        tracks = dm.probe_tracks(i)
        fh, fhc, ff, need_db = floors(tracks, console, loss_fn,
                                      probe_params(tracks, console, i) if params is None else params[i])
        rows.append({
            "probe_batch": i,
            "floor_half_render": round(fh, 4),
            "floor_half_render_clipped": round(fhc, 4),
            "floor_full_render_crop": round(ff, 4),
            "output_fader_needed_db": [round(float(d), 2) for d in need_db],
            "wall_s": round(time.time() - t0, 1),
        })
        exact.append((fh, fhc, ff))
        print(rows[-1], flush=True)
    baseline = probe_baseline(dm, console, loss_fn, n_probe, params)
    fh_mean, fhc_mean, ff_mean = (float(m) for m in np.mean(exact, axis=0))
    max_db = max(abs(d) for r in rows for d in r["output_fader_needed_db"])
    return {
        "probe_batches": rows,
        "floor_half_render_mean": fh_mean,
        "floor_half_render_clipped_mean": fhc_mean,
        "floor_full_render_crop_mean": ff_mean,
        "equal_gain_sum_baseline": baseline,
        "output_fader_within_range": bool(max_db <= 48.0),
        "max_abs_needed_db": round(float(max_db), 2),
    }


def main(argv=None):
    args = parse(argv, __doc__.splitlines()[0])
    dev = resolve_device(args.device)
    use_full_float32()
    name, smi = card(dev)
    print("device:", dev, name, smi, flush=True)
    console = AdvancedMixConsole(SR, device=str(dev))
    loss_fn = MultiResolutionSTFTLoss()
    dm = SyntheticDM(1, device=dev, **toy_probe(args.toy))  # only the probe set is used
    got = probe_floors(dm, console, loss_fn, dm.n_probe)
    fh_mean, ff_mean = got["floor_half_render_mean"], got["floor_full_render_crop_mean"]
    summary = {
        "backend": name,
        "power_limit": smi,
        "what": (
            "probe-loss of the ORACLE params that generated each probe reference mix, rendered as the "
            "eval renders predictions (second-half stems, faders expressing the peak-normalization "
            "gain) — the achievable floor of logs/train_demo_torch.json's probe curve"
        ),
        "probe_batches": got["probe_batches"],
        "floor_half_render_mean": round(fh_mean, 4),
        "floor_half_render_clipped_mean": round(got["floor_half_render_clipped_mean"], 4),
        "floor_full_render_crop_mean": round(ff_mean, 4),
        "boundary_effect": round(fh_mean - ff_mean, 4),
        "equal_gain_sum_baseline": round(got["equal_gain_sum_baseline"], 4),
        "output_fader_within_range": got["output_fader_within_range"],
        "max_abs_needed_db": got["max_abs_needed_db"],
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    os.makedirs("logs", exist_ok=True)
    with open("logs/probe_floor_torch.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
