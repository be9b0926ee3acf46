"""Knowledge-engineering reference-mix generator.

Port of ``diffmst_tpu/mixing/knowledge.py``: instrument-aware heuristic
mixing. Each track's gain, pan, EQ, compressor and send are sampled from its
instrument class's ranges in a KE YAML (``data/knowledge_engineering.yaml``:
class -> {instruments: [...], gain: [lo, hi], pan: [candidates], eq: {...},
compressor: {...}}, with ``fx_bus`` and ``master_bus`` sections); the second
track of a stereo pair takes the mirrored pan; the values are clamped into
the console's ranges, normalized to (0, 1) and rendered through the console
without gradients.

``sample_ke_params`` is host NumPy, the JAX package's line for line: for the
same ``np.random.Generator`` and inputs its arrays are bitwise JAX's. The
train step samples on the host and renders on the device
(``train/system.py``), as JAX's System does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffmst_torch.console.ranges import normalize
from diffmst_torch.mixing.naive import NaiveRandomMix, naive_random_mix

__all__ = ["instrument_metadata", "knowledge_engineering_mix", "sample_ke_params", "load_vendored_ke"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_EQ_KE_TO_CONSOLE = {
    "eq_lowshelf_gain": "low_shelf_gain_db",
    "eq_lowshelf_freq": "low_shelf_cutoff_freq",
    "eq_lowshelf_q": "low_shelf_q_factor",
    "eq_band0_gain": "band0_gain_db",
    "eq_band0_freq": "band0_cutoff_freq",
    "eq_band0_q": "band0_q_factor",
    "eq_band1_gain": "band1_gain_db",
    "eq_band1_freq": "band1_cutoff_freq",
    "eq_band1_q": "band1_q_factor",
    "eq_band2_gain": "band2_gain_db",
    "eq_band2_freq": "band2_cutoff_freq",
    "eq_band2_q": "band2_q_factor",
    "eq_band3_gain": "band3_gain_db",
    "eq_band3_freq": "band3_cutoff_freq",
    "eq_band3_q": "band3_q_factor",
    "eq_highshelf_gain": "high_shelf_gain_db",
    "eq_highshelf_freq": "high_shelf_cutoff_freq",
    "eq_highshelf_q": "high_shelf_q_factor",
}

# track-param vector layout indices (console/ranges.py)
_EQ_ORDER = [
    "low_shelf_gain_db", "low_shelf_cutoff_freq", "low_shelf_q_factor",
    "band0_gain_db", "band0_cutoff_freq", "band0_q_factor",
    "band1_gain_db", "band1_cutoff_freq", "band1_q_factor",
    "band2_gain_db", "band2_cutoff_freq", "band2_q_factor",
    "band3_gain_db", "band3_cutoff_freq", "band3_q_factor",
    "high_shelf_gain_db", "high_shelf_cutoff_freq", "high_shelf_q_factor",
]
_COMP_ORDER = [
    "threshold_db", "ratio", "attack_ms", "release_ms", "knee_db",
    "makeup_gain_db",
]

_EQ_CONSOLE_TO_KE = {v: k for k, v in _EQ_KE_TO_CONSOLE.items()}

_DEFAULT_CLASS = {
    "gain": [-12.0, -6.0],
    "pan": [0.3, 0.7],
    "eq": {k: [0.0, 0.0] if "gain" in k else None for k in _EQ_KE_TO_CONSOLE},
    "compressor": {
        "threshold_db": [-20.0, -10.0], "ratio": [1.5, 3.0],
        "attack_ms": [10.0, 100.0], "release_ms": [10.0, 100.0],
        "knee_db": [3.0, 6.0], "makeup_gain_db": [0.0, 3.0],
    },
}


def instrument_metadata(
    instrument_id: np.ndarray, instrument_number_file: Dict[str, int]
) -> List[List[str]]:
    """ids -> instrument names per (batch, track) (mixing.py:6-32)."""
    id2name = {v: k for k, v in instrument_number_file.items()}
    return [
        [id2name.get(int(i), "unknown") for i in row]
        for row in np.asarray(instrument_id)
    ]


def _find_class(ke: Dict, instrument: str) -> Dict:
    name = instrument.lower()
    for cls, spec in ke.items():
        if cls in ("fx_bus", "master_bus") or not isinstance(spec, dict):
            continue
        members = [m.lower() for m in spec.get("instruments", [])]
        if name in members:
            return spec
    for cls, spec in ke.items():  # substring fallback
        if cls in ("fx_bus", "master_bus") or not isinstance(spec, dict):
            continue
        for m in spec.get("instruments", []):
            if m.lower() in name or name in m.lower():
                return spec
    return _DEFAULT_CLASS


def _sample(rng: np.random.Generator, lohi: Optional[Sequence[float]], default):
    if not lohi:
        lo, hi = default
    else:
        lo, hi = float(lohi[0]), float(lohi[1])
    return rng.uniform(lo, hi) if hi > lo else lo


def _choice(rng: np.random.Generator, values: Optional[Sequence[float]], default):
    """Discrete draw over candidate values — the KE YAML stores *pan* as a
    list of candidates, not a range (the reference draws it with
    random.choice, mixing.py:312; e.g. the extreme-panned percussion class
    lists [1.0, 0.0], and some classes list 3+ candidates)."""
    if not values:
        return _sample(rng, None, default)
    return float(values[int(rng.integers(len(values)))])


def _norm_clip(value: float, rng_pair) -> float:
    lo, hi = rng_pair
    return float(np.clip(normalize(value, lo, hi), 0.0, 1.0))


def load_vendored_ke() -> Dict:
    """Default KE ranges: the vendored reference metadata
    (``data/knowledge_engineering.yaml`` at the repository root)."""
    import yaml

    path = os.path.join(REPO_ROOT, "data", "knowledge_engineering.yaml")
    if not os.path.exists(path):
        raise ValueError(
            "knowledge_engineering_mix: pass ke_dict= or vendor "
            "data/knowledge_engineering.yaml at the repo root"
        )
    with open(path) as f:
        return yaml.safe_load(f)


def sample_ke_params(
    ke_dict: Dict,
    mdata: List[List[str]],
    stereo: np.ndarray,
    rng: np.random.Generator,
    mix_console,
) -> tuple:
    """Host-side KE parameter sampling: instrument names -> normalized
    (track, fx-bus, master-bus) parameter arrays.

    The string-metadata half of ``knowledge_engineering_mix``: the train
    step runs it on the host and renders its small arrays on the device.
    NumPy by nature, like the reference's."""
    bs = len(mdata)
    num_tracks = len(mdata[0]) if bs else 0
    ranges = mix_console.param_ranges

    tp = np.zeros((bs, num_tracks, mix_console.num_track_control_params), np.float32)
    for b in range(bs):
        mirror_pan: Optional[float] = None
        for t in range(num_tracks):
            spec = _find_class(ke_dict, mdata[b][t])
            gain = _sample(rng, spec.get("gain"), _DEFAULT_CLASS["gain"])
            tp[b, t, 0] = _norm_clip(gain, ranges["input_fader"]["gain_db"])

            eq_spec = spec.get("eq") or {}
            for i, console_name in enumerate(_EQ_ORDER):
                lo_hi = eq_spec.get(_EQ_CONSOLE_TO_KE[console_name])
                default = (
                    (0.0, 0.0)
                    if console_name.endswith("gain_db")
                    else ranges["parametric_eq"][console_name]
                )
                val = _sample(rng, lo_hi, default)
                tp[b, t, 1 + i] = _norm_clip(
                    val, ranges["parametric_eq"][console_name]
                )

            comp_spec = spec.get("compressor") or {}
            for i, name in enumerate(_COMP_ORDER):
                val = _sample(
                    rng, comp_spec.get(name), _DEFAULT_CLASS["compressor"][name]
                )
                tp[b, t, 19 + i] = _norm_clip(val, ranges["compressor"][name])

            # pan (discrete candidates, mixing.py:312), with stereo-pair
            # mirroring (mixing.py:705-722)
            if mirror_pan is not None:
                pan = 1.0 - mirror_pan
                mirror_pan = None
            else:
                pan = _choice(rng, spec.get("pan"), _DEFAULT_CLASS["pan"])
                if stereo[b, t] == 1:
                    mirror_pan = pan
            tp[b, t, 25] = _norm_clip(pan, ranges["stereo_panner"]["pan"])

            send = _sample(
                rng, (ke_dict.get("fx_bus") or {}).get("send_db"), (-80.0, -20.0)
            )
            tp[b, t, 26] = _norm_clip(send, ranges["fx_bus"]["send_db"])

    # fx bus (12 gains + 12 decays + mix)
    fx = np.zeros((bs, mix_console.num_fx_bus_control_params), np.float32)
    fx_spec = ke_dict.get("fx_bus") or {}
    for b in range(bs):
        for i in range(12):
            g = _sample(rng, (fx_spec.get("reverb_gain") or {}).get(f"band_{i}"), (0, 1))
            d = _sample(rng, (fx_spec.get("reverb_decay") or {}).get(f"band_{i}"), (0, 1))
            fx[b, i] = _norm_clip(g, ranges["reverberation"][f"band{i}_gain"])
            fx[b, 12 + i] = _norm_clip(d, ranges["reverberation"][f"band{i}_decay"])
        fx[b, 24] = _norm_clip(
            _sample(rng, fx_spec.get("mix"), (0, 1)), ranges["reverberation"]["mix"]
        )

    # master bus (EQ 18, comp 6, output fader, input fader)
    mp = np.zeros((bs, mix_console.num_master_bus_control_params), np.float32)
    m_spec = ke_dict.get("master_bus") or {}
    for b in range(bs):
        eq_spec = m_spec.get("eq") or {}
        for i, console_name in enumerate(_EQ_ORDER):
            default = (
                (0.0, 0.0)
                if console_name.endswith("gain_db")
                else ranges["parametric_eq"][console_name]
            )
            mp[b, i] = _norm_clip(
                _sample(rng, eq_spec.get(_EQ_CONSOLE_TO_KE[console_name]), default),
                ranges["parametric_eq"][console_name],
            )
        comp_spec = m_spec.get("compressor") or {}
        for i, name in enumerate(_COMP_ORDER):
            mp[b, 18 + i] = _norm_clip(
                _sample(rng, comp_spec.get(name), _DEFAULT_CLASS["compressor"][name]),
                ranges["compressor"][name],
            )
        # "fader" in the KE YAML drives the *output* fader (the reference's
        # "fader" key is the rotted name of input_fader; intended behavior)
        fader = (m_spec.get("fader") or {}).get("gain_db")
        mp[b, 24] = _norm_clip(
            _sample(rng, fader, (-10.0, 0.0)), ranges["output_fader"]["gain_db"]
        )
        mp[b, 25] = _norm_clip(0.0, ranges["input_fader"]["gain_db"])
    return tp, fx, mp


def knowledge_engineering_mix(
    tracks: torch.Tensor,
    mix_console,
    generator: Optional[torch.Generator] = None,
    instrument_id: Optional[np.ndarray] = None,
    stereo_id: Optional[np.ndarray] = None,
    instrument_number_file: Optional[Dict[str, int]] = None,
    ke_dict: Optional[Dict] = None,
    use_track_input_fader: bool = True,
    use_track_eq: bool = True,
    use_track_compressor: bool = True,
    use_track_panner: bool = True,
    use_fx_bus: bool = True,
    use_master_bus: bool = True,
    use_output_fader: bool = True,
    seed: Optional[int] = None,
    params=None,
    noise=None,
    **_unused,
) -> NaiveRandomMix:
    """Instrument-aware heuristic mix of (bs, num_tracks, seq_len) stems;
    returns the ``naive_random_mix`` 8-tuple, without gradients.

    RNG: ``seed`` wins if given; otherwise one 31-bit draw from
    ``generator`` seeds the NumPy sampler (distinct generator states give
    distinct mixes); with neither, seed 0. Given ``params`` (track, fx bus,
    master bus), normalized, those are rendered instead of a draw. With the
    fx bus, the reverb takes ``noise``, or draws it from ``generator`` (a
    generator seeded ``seed`` when there is none), as JAX's takes its key.
    """
    if params is None:
        bs, num_tracks, _ = tracks.shape
        if seed is None:
            seed = (int(torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device))
                    if generator is not None else 0)
        if instrument_id is None or instrument_number_file is None:
            mdata = [["unknown"] * num_tracks for _ in range(bs)]
        else:
            mdata = instrument_metadata(instrument_id, instrument_number_file)
        stereo = np.zeros((bs, num_tracks), np.int64) if stereo_id is None else np.asarray(stereo_id)
        params = tuple(
            torch.from_numpy(p)
            for p in sample_ke_params(load_vendored_ke() if ke_dict is None else ke_dict, mdata, stereo,
                                      np.random.default_rng(seed), mix_console)
        )
    if generator is None:
        generator = torch.Generator().manual_seed(0 if seed is None else seed)
    return naive_random_mix(
        tracks,
        mix_console,
        generator,
        use_track_input_fader=use_track_input_fader,
        use_track_eq=use_track_eq,
        use_track_compressor=use_track_compressor,
        use_track_panner=use_track_panner,
        use_fx_bus=use_fx_bus,
        use_master_bus=use_master_bus,
        use_output_fader=use_output_fader,
        params=tuple(p.to(tracks.device, tracks.dtype) for p in params),
        noise=noise,
    )


# The train step checks this flag to sample on the host (System._host_sample_ke).
knowledge_engineering_mix.host_side = True
