"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  * K1 ``scan1p.onepole_core`` — the one-pole scan (``csrc/scan1p.cu``);
  * K2 ``comp_fused.compressor_fused_gain`` — the fused compressor
    (``csrc/comp_fused.cu``);
  * K3 ``scan1p.release_min_scan`` — the decoupled compressor's release
    min-scan (``csrc/scan1p.cu``);
  * K5 ``iir_fused.sosfilt`` — the causal biquad cascade
    (``csrc/iir_fused.cu``).

Each has its backward kernel. Sources build at first use (``_build.py``);
importing this package builds nothing.
"""

from diffmst_torch.kernels.comp_fused import compressor_fused_gain, compressor_fused_gain_plain
from diffmst_torch.kernels.iir_fused import sosfilt, sosfilt_plain
from diffmst_torch.kernels.scan1p import (
    onepole_core,
    onepole_core_plain,
    release_min_scan,
    release_min_scan_plain,
)

__all__ = [
    "onepole_core",
    "onepole_core_plain",
    "compressor_fused_gain",
    "compressor_fused_gain_plain",
    "release_min_scan",
    "release_min_scan_plain",
    "sosfilt",
    "sosfilt_plain",
]
