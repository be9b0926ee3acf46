"""Console parameter registry: ranges, denormalization, vector <-> dict layout.

Port of ``diffmst_tpu/console/ranges.py``. Track vectors are 27 wide (fader 1,
EQ 18, compressor 6, pan 1, send 1), fx-bus vectors 25 (12 band gains, 12
band decays, mix forced to 1) and master-bus vectors 26 (EQ 18, compressor
6, output fader, input fader).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "advanced_param_ranges",
    "basic_param_ranges",
    "denormalize",
    "normalize",
    "denormalize_parameters",
    "validate_normalized",
    "split_track_params",
    "split_fx_bus_params",
    "split_master_bus_params",
    "NUM_TRACK_PARAMS",
    "NUM_FX_BUS_PARAMS",
    "NUM_MASTER_BUS_PARAMS",
]

NUM_TRACK_PARAMS = 27
NUM_FX_BUS_PARAMS = 25
NUM_MASTER_BUS_PARAMS = 26

Range = Tuple[float, float]
ParamDict = Dict[str, Dict[str, torch.Tensor]]


def _eq_ranges(eq_min_gain_db: float, eq_max_gain_db: float, sample_rate: float):
    g = (eq_min_gain_db, eq_max_gain_db)
    q = (0.1, 5.0)
    return {
        "low_shelf_gain_db": g,
        "low_shelf_cutoff_freq": (20.0, 2000.0),
        "low_shelf_q_factor": q,
        "band0_gain_db": g,
        "band0_cutoff_freq": (80.0, 2000.0),
        "band0_q_factor": q,
        "band1_gain_db": g,
        "band1_cutoff_freq": (2000.0, 8000.0),
        "band1_q_factor": q,
        "band2_gain_db": g,
        "band2_cutoff_freq": (8000.0, 12000.0),
        "band2_q_factor": q,
        "band3_gain_db": g,
        "band3_cutoff_freq": (12000.0, (sample_rate // 2) - 1000.0),
        "band3_q_factor": q,
        "high_shelf_gain_db": g,
        "high_shelf_cutoff_freq": (6000.0, (sample_rate // 2) - 1000.0),
        "high_shelf_q_factor": q,
    }


def advanced_param_ranges(
    sample_rate: float,
    input_min_gain_db: float = -48.0,
    input_max_gain_db: float = 48.0,
    output_min_gain_db: float = -48.0,
    output_max_gain_db: float = 48.0,
    min_send_db: float = -80.0,
    max_send_db: float = 12.0,
    eq_min_gain_db: float = -12.0,
    eq_max_gain_db: float = 12.0,
    min_pan: float = 0.0,
    max_pan: float = 1.0,
    reverb_min_band_gain: float = 0.0,
    reverb_max_band_gain: float = 1.0,
    reverb_min_band_decay: float = 0.0,
    reverb_max_band_decay: float = 1.0,
) -> Dict[str, Dict[str, Range]]:
    """Full AdvancedMixConsole range registry."""
    reverb = {f"band{i}_gain": (reverb_min_band_gain, reverb_max_band_gain) for i in range(12)}
    reverb.update(
        {f"band{i}_decay": (reverb_min_band_decay, reverb_max_band_decay) for i in range(12)}
    )
    reverb["mix"] = (0.0, 1.0)
    return {
        "input_fader": {"gain_db": (input_min_gain_db, input_max_gain_db)},
        "output_fader": {"gain_db": (output_min_gain_db, output_max_gain_db)},
        "parametric_eq": _eq_ranges(eq_min_gain_db, eq_max_gain_db, sample_rate),
        "compressor": {
            "threshold_db": (-60.0, 0.0),
            "ratio": (1.0, 10.0),
            "attack_ms": (5.0, 250.0),
            "release_ms": (10.0, 250.0),
            "knee_db": (3.0, 12.0),
            "makeup_gain_db": (0.0, 6.0),
        },
        "reverberation": reverb,
        "fx_bus": {"send_db": (min_send_db, max_send_db)},
        "stereo_panner": {"pan": (min_pan, max_pan)},
    }


def basic_param_ranges(
    input_min_gain_db: float = -48.0,
    input_max_gain_db: float = 48.0,
    min_pan: float = 0.0,
    max_pan: float = 1.0,
) -> Dict[str, Dict[str, Range]]:
    """BasicMixConsole (gain + pan) range registry."""
    return {
        "input_fader": {"gain_db": (input_min_gain_db, input_max_gain_db)},
        "stereo_panner": {"pan": (min_pan, max_pan)},
    }


def denormalize(norm_val, max_val, min_val):
    """(0,1) -> [min_val, max_val]. Argument order mirrors the reference."""
    return norm_val * (max_val - min_val) + min_val


def normalize(val, min_val, max_val):
    """[min_val, max_val] -> (0,1), the inverse of ``denormalize``."""
    return (val - min_val) / (max_val - min_val)


def denormalize_parameters(
    param_dict: ParamDict, param_ranges: Dict[str, Dict[str, Range]]
) -> ParamDict:
    """Map every (0,1) parameter tensor to its physical range."""
    out = {}
    for effect, params in param_dict.items():
        out[effect] = {}
        for name, val in params.items():
            lo, hi = param_ranges[effect][name]
            out[effect][name] = denormalize(val, hi, lo)
    return out


def validate_normalized(param_dict: ParamDict) -> None:
    """Raise ``ValueError`` where a normalized parameter leaves [0, 1], with
    JAX's message (the reference raises inside its forward; this check
    reads every tensor to the host, so call it outside a traced graph)."""
    for effect, params in param_dict.items():
        for name, val in params.items():
            lo = float(torch.min(val))
            hi = float(torch.max(val))
            if lo < 0.0 or hi > 1.0:
                raise ValueError(f"Parameter {name} of effect {effect} is out of range [{lo}, {hi}].")


_EQ_KEYS = [
    "low_shelf_gain_db", "low_shelf_cutoff_freq", "low_shelf_q_factor",
    "band0_gain_db", "band0_cutoff_freq", "band0_q_factor",
    "band1_gain_db", "band1_cutoff_freq", "band1_q_factor",
    "band2_gain_db", "band2_cutoff_freq", "band2_q_factor",
    "band3_gain_db", "band3_cutoff_freq", "band3_q_factor",
    "high_shelf_gain_db", "high_shelf_cutoff_freq", "high_shelf_q_factor",
]
_COMP_KEYS = [
    "threshold_db", "ratio", "attack_ms", "release_ms", "knee_db", "makeup_gain_db",
]


def split_track_params(p: torch.Tensor) -> ParamDict:
    """(..., 27) normalized vector -> nested effect dict."""
    return {
        "input_fader": {"gain_db": p[..., 0]},
        "parametric_eq": {k: p[..., 1 + i] for i, k in enumerate(_EQ_KEYS)},
        "compressor": {k: p[..., 19 + i] for i, k in enumerate(_COMP_KEYS)},
        "stereo_panner": {"pan": p[..., 25]},
        "fx_bus": {"send_db": p[..., 26]},
    }


def split_fx_bus_params(p: torch.Tensor) -> ParamDict:
    """(..., 25) -> reverberation dict; the wet/dry mix is forced to 1."""
    rev = {f"band{i}_gain": p[..., i] for i in range(12)}
    rev.update({f"band{i}_decay": p[..., 12 + i] for i in range(12)})
    rev["mix"] = torch.ones_like(p[..., 24])
    return {"reverberation": rev}


def split_master_bus_params(p: torch.Tensor) -> ParamDict:
    """(..., 26) -> master bus dict."""
    return {
        "parametric_eq": {k: p[..., i] for i, k in enumerate(_EQ_KEYS)},
        "compressor": {k: p[..., 18 + i] for i, k in enumerate(_COMP_KEYS)},
        "output_fader": {"gain_db": p[..., 24]},
        "input_fader": {"gain_db": p[..., 25]},
    }
