"""K2: the fused compressor — detector, soft knee, one-pole and gain in one pass.

``compressor_fused_gain(x, x_delayed, threshold_db, ratio, knee_db, alpha,
makeup_db)`` returns x_delayed * 10^((g_s + makeup) / 20), where g_s is the
one-pole-smoothed soft-knee gain of x in dB. x and x_delayed are (B, T)
float32 rows; the five parameters are (B,). It equals the compressor's
``"scan"`` smoother numerically (``ops/compressor.py``).

Replaces the Pallas kernel ``diffmst_tpu/kernels/comp_fused.py::_fused_core``
(pallas_call at comp_fused.py:98; public ``compressor_fused_gain``:136).
Kernel: ``csrc/comp_fused.cu``, a hand-written CUDA kernel for Hopper
(sm_90a), loaded with ctypes.

Bound on the card: memory. The least traffic is read x + read x_delayed +
write out, 12 bytes a sample: 100.7 MB at 32 x 262,144, about 30 us at the
H100 SXM's 3.35 TB/s. x_db, the static gain and the smoothed envelope stay in
registers. Like K1 the kernel is a three-pass chunked scan over the rows in
place (``csrc/scan_common.cuh``), composed in float64, with the level
detector and the knee computed as each sample is loaded. On an NVIDIA H100
80GB HBM3 at 700 W it takes 0.16 ms at 32 x 262,144, five times the bound
(``chip_smoke.py``; PERF.md).

The knee is clamped to at least 1e-3 dB (comp_fused.py:151) so the knee
division never sees 0. The Pallas kernel also set the knee of its padded
lanes to 1 (comp_fused.py:94-95); this kernel works on the rows as they are
and pads none.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from diffmst_torch.kernels._build import check_launch, load_library
from diffmst_torch.kernels.scan1p import onepole_core_plain

__all__ = ["compressor_fused_gain", "compressor_fused_gain_plain"]

_LN10 = math.log(10.0)


def _param_rows(threshold_db, ratio, knee_db, alpha, makeup_db) -> torch.Tensor:
    """(5, B): threshold, 1/ratio - 1, clamped knee, alpha, makeup."""
    knee = torch.clamp(knee_db, min=1e-3)
    return torch.stack([threshold_db, 1.0 / ratio - 1.0, knee, alpha, makeup_db], dim=0)


def compressor_fused_gain_plain(
    x: torch.Tensor,
    x_delayed: torch.Tensor,
    threshold_db: torch.Tensor,
    ratio: torch.Tensor,
    knee_db: torch.Tensor,
    alpha: torch.Tensor,
    makeup_db: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Plain PyTorch version of K2: the kernel's equations in float32 and
    K1's plain scan, which composes in float64 as the kernels do."""
    thr, irm1, knee, a, makeup = _param_rows(
        threshold_db, ratio, knee_db, alpha, makeup_db
    )[:, :, None]
    x_db = (20.0 / _LN10) * torch.log(torch.clamp(torch.abs(x), min=eps))
    over = x_db - thr
    in_knee = irm1 * torch.square(over + knee * 0.5) / (2.0 * knee)
    above = irm1 * over
    g_c = torch.where(
        over <= -knee * 0.5,
        torch.zeros_like(over),
        torch.where(over >= knee * 0.5, above, in_knee),
    )
    g_s = onepole_core_plain((1.0 - a) * g_c, a[:, 0])
    return x_delayed * torch.exp((_LN10 / 20.0) * (g_s + makeup))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("comp_fused.cu")
    lib.diffmst_compressor_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.diffmst_compressor_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_compressor_fused_gain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.diffmst_compressor_fused_gain.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, x_delayed: torch.Tensor, params: torch.Tensor) -> None:
    for name, t in (("x", x), ("x_delayed", x_delayed), ("params", params)):
        if t.dtype != torch.float32:
            raise TypeError(f"compressor_fused_gain takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"compressor_fused_gain takes a contiguous {name}")
    if x.ndim != 2 or x_delayed.shape != x.shape or params.shape != (5, x.shape[0]):
        raise ValueError(
            f"compressor_fused_gain takes x, x_delayed (B, T) and (B,) parameters; got "
            f"{tuple(x.shape)}, {tuple(x_delayed.shape)}, params {tuple(params.shape)}"
        )
    if x.shape[0] > 65535:
        raise ValueError(f"compressor_fused_gain takes at most 65535 rows, got {x.shape[0]}")
    if x.device.type != "cuda":
        raise ValueError(f"the compressor_fused_gain kernel runs on a CUDA device, not {x.device}")


def _launch(x: torch.Tensor, x_delayed: torch.Tensor, params: torch.Tensor, eps: float):
    _check(x, x_delayed, params)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows, t = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(
            lib.diffmst_compressor_scratch_bytes(rows, t), dtype=torch.uint8, device=x.device
        )
        err = lib.diffmst_compressor_fused_gain(
            x.data_ptr(), x_delayed.data_ptr(), params.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), rows, t, eps, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "compressor_fused_gain")
    compressor_fused_gain.launches += 1
    return out


class _CompressorKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, x_delayed, params, eps):
        return _launch(x, x_delayed, params, eps)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "the K2 backward (the recompute VJP of diffmst_tpu "
            "kernels/comp_fused.py:167-176) is not ported yet: ROADMAP Queue 2"
        )


def compressor_fused_gain(
    x: torch.Tensor,
    x_delayed: torch.Tensor,
    threshold_db: torch.Tensor,
    ratio: torch.Tensor,
    knee_db: torch.Tensor,
    alpha: torch.Tensor,
    makeup_db: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Compressed x_delayed, gain detected on x. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return compressor_fused_gain_plain(
            x, x_delayed, threshold_db, ratio, knee_db, alpha, makeup_db, eps
        )
    params = _param_rows(threshold_db, ratio, knee_db, alpha, makeup_db).contiguous()
    return _CompressorKernel.apply(x, x_delayed, params, eps)


# Kernel launches (CUDA calls only); callers reset it to 0 to count a run.
compressor_fused_gain.launches = 0
