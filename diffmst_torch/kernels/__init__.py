"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  * K1 ``scan1p.onepole_core`` — the one-pole scan (``csrc/scan1p.cu``);
  * K2 ``comp_fused.compressor_fused_gain`` — the fused compressor
    (``csrc/comp_fused.cu``);
  * K3 ``scan1p.release_min_scan`` — the decoupled compressor's release
    min-scan (``csrc/scan1p.cu``);
  * K5 ``iir_fused.sosfilt`` — the causal biquad cascade
    (``csrc/iir_fused.cu``);
  * ``smoother.ballistics`` — the branching attack/release smoother
    (``csrc/ballistics.cu``), whose backward is K1's with a per-sample
    alpha (K4's).

K1-K5 have their backward kernels. Sources build at first use (``_build.py``);
importing this package builds nothing.

Each wrapper counts its launches on CUDA tensors in attributes of the
wrapper function; ``launch_counts`` reads them all and
``set_launch_counts`` writes them (a CUDA graph's replay launches without
the wrappers, so ``train/fused.py`` adds what its capture counted).
"""

from typing import Dict

from diffmst_torch.kernels import comp_fused, iir_fused, scan1p, smoother
from diffmst_torch.kernels.comp_fused import compressor_fused_gain, compressor_fused_gain_plain
from diffmst_torch.kernels.iir_fused import sosfilt, sosfilt_plain
from diffmst_torch.kernels.scan1p import (
    onepole_core,
    onepole_core_plain,
    release_min_scan,
    release_min_scan_plain,
)
from diffmst_torch.kernels.smoother import ballistics, ballistics_plain

# name -> (wrapper function, attribute) of every launch counter; the
# functions as imported, whatever a caller swaps into their modules later
_COUNTERS = {
    "K1": (scan1p.onepole_core, "launches"),
    "K1-bwd": (scan1p.onepole_core_backward, "launches"),
    "K4": (scan1p.onepole_core, "launches_per_sample"),
    "K4-bwd": (scan1p.onepole_core_backward, "launches_per_sample"),
    "K2": (comp_fused.compressor_fused_gain, "launches"),
    "K2-bwd": (comp_fused.compressor_fused_backward, "launches"),
    "K3": (scan1p.release_min_scan, "launches"),
    "K3-bwd": (scan1p.release_min_scan_backward, "launches"),
    "K5": (iir_fused.sosfilt, "launches"),
    "K5-bwd": (iir_fused.sosfilt_backward, "launches"),
    "ballistics": (smoother.ballistics, "launches"),
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by name (K1-K5, their backward
    kernels, K4 and K4-bwd, ballistics)."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _COUNTERS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set the counters named in ``counts``."""
    for name, value in counts.items():
        fn, attr = _COUNTERS[name]
        setattr(fn, attr, value)


__all__ = [
    "launch_counts",
    "set_launch_counts",
    "ballistics",
    "ballistics_plain",
    "onepole_core",
    "onepole_core_plain",
    "compressor_fused_gain",
    "compressor_fused_gain_plain",
    "release_min_scan",
    "release_min_scan_plain",
    "sosfilt",
    "sosfilt_plain",
]
