"""K1: first-order linear recurrence (one-pole) scan along time.

``onepole_core(b, alpha)`` computes y[n] = a * y[n-1] + b[n] over the last
axis of (B, T) float32 rows from y[-1] = 0, with ``alpha`` of shape (B,) (one
coefficient a row) or (B, T) (one a sample). It is the compressor's
ballistics smoother (``ops/compressor.py``, smoother ``"scan"``).

Replaces the Pallas kernel ``diffmst_tpu/kernels/scan1p.py::onepole_core``
(pallas_call at scan1p.py:111). Kernel: ``csrc/scan1p.cu``, a hand-written
CUDA kernel for Hopper (sm_90a), loaded with ctypes.

Bound on the card: memory. The least traffic is read b + write y, 8 bytes a
sample (12 with a per-sample alpha): 67.1 MB at 32 x 262,144, about 20 us at
the H100 SXM's 3.35 TB/s. The Pallas kernel walked time chunks in order on
one core with its carry in VMEM and the batch on 128 lanes (B = 8 or 32 padded
to 128). On the GPU one block per row would occupy 8-32 of 132 SMs, so the
kernel is a three-pass chunked scan over the rows in place
(``csrc/scan_common.cuh``): chunk totals, a scan of the totals per row, and
a pass that applies each chunk's carry-in. It composes the maps in float64
and rounds once, as float32, so a pole near 1 costs it no accuracy. On an
NVIDIA H100 80GB HBM3 at 700 W it takes 0.12 ms at 32 x 262,144, six times
the bound (``chip_smoke.py``; PERF.md).

On a CPU tensor the wrapper runs ``onepole_core_plain``, the same three-level
algorithm in PyTorch ops; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from diffmst_torch.kernels._build import check_launch, load_library

__all__ = ["onepole_core", "onepole_core_plain"]


def _hillis_steele(A: torch.Tensor, B: torch.Tensor):
    """Inclusive scan of the maps y -> A*y + B along the last axis."""
    n = A.shape[-1]
    d = 1
    while d < n:
        A_prev = F.pad(A[..., :-d], (d, 0), value=1.0)
        B_prev = F.pad(B[..., :-d], (d, 0))
        B = A * B_prev + B
        A = A * A_prev
        d *= 2
    return A, B


def onepole_core_plain(b: torch.Tensor, alpha: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K1: a Hillis-Steele scan inside each chunk of
    ``chunk`` samples (as scan1p.py:56-72), a scan of the chunk totals, and
    the carry-in applied to every chunk. Like the kernel it composes in
    float64 and rounds once, to the input's type."""
    bs, t = b.shape
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    B = F.pad(b.double(), (0, pad)).reshape(bs, n_chunks, chunk)
    if alpha.ndim == 2:
        # padded samples get a = 1, b = 0: they carry the state unchanged
        A = F.pad(alpha.double(), (0, pad), value=1.0).reshape(bs, n_chunks, chunk)
    else:
        A = alpha.double()[:, None, None].expand(bs, n_chunks, chunk)
    A, B = _hillis_steele(A, B)
    _, B_tot = _hillis_steele(A[..., -1], B[..., -1])
    carry = F.pad(B_tot[:, :-1], (1, 0))  # state entering each chunk
    y = B + A * carry[..., None]
    return y.reshape(bs, n_chunks * chunk)[:, :t].to(b.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("scan1p.cu")
    lib.diffmst_onepole_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.diffmst_onepole_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_onepole_core.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_onepole_core.restype = ctypes.c_int
    return lib


def _check(b: torch.Tensor, alpha: torch.Tensor) -> None:
    if b.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise TypeError(f"onepole_core takes float32, got {b.dtype} and {alpha.dtype}")
    if b.ndim != 2 or alpha.shape not in ((b.shape[0],), tuple(b.shape)):
        raise ValueError(
            f"onepole_core takes b (B, T) and alpha (B,) or (B, T); got "
            f"{tuple(b.shape)} and {tuple(alpha.shape)}"
        )
    if alpha.device != b.device:
        raise ValueError(f"b on {b.device} but alpha on {alpha.device}")
    if not (b.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("onepole_core takes contiguous tensors")
    if b.shape[0] > 65535:
        raise ValueError(f"onepole_core takes at most 65535 rows, got {b.shape[0]}")
    if b.device.type != "cuda":
        raise ValueError(f"the onepole_core kernel runs on a CUDA device, not {b.device}")


def _launch(b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    _check(b, alpha)
    y = torch.empty_like(b)
    if b.numel() == 0:
        return y
    rows, t = b.shape
    lib = _lib()
    with torch.cuda.device(b.device):
        scratch = torch.empty(
            lib.diffmst_onepole_scratch_bytes(rows, t), dtype=torch.uint8, device=b.device
        )
        err = lib.diffmst_onepole_core(
            b.data_ptr(), alpha.data_ptr(), int(alpha.ndim == 2), y.data_ptr(),
            scratch.data_ptr(), rows, t, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "onepole_core")
    onepole_core.launches += 1
    return y


class _OnepoleKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, alpha):
        return _launch(b, alpha)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(
            "the K1 backward (the reverse-time one-pole, diffmst_tpu "
            "kernels/scan1p.py:142-150) is not ported yet: ROADMAP Queue 2"
        )


def onepole_core(b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """y[n] = alpha * y[n-1] + b[n] over the last axis of b (B, T); alpha (B,)
    or (B, T). CPU tensors take the plain version, CUDA tensors the kernel."""
    if b.device.type == "cpu":
        return onepole_core_plain(b, alpha)
    return _OnepoleKernel.apply(b, alpha)


# Kernel launches (CUDA calls only); callers reset it to 0 to count a run.
onepole_core.launches = 0
