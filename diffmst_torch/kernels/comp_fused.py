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
H100 SXM's 3.35 TB/s. x_db, the static gain and the smoothed envelope stay
on chip. The kernel is one single-pass scan with decoupled look-back
(``csrc/lookback.cuh``): each block takes a 4,096-sample tile of a row from
an atomic ticket, copies x and then x_delayed into shared memory with
cp.async, scans its tile from zero in float64, takes the state entering
it from the tiles before it (their aggregates, published as 64-bit words
over a fill pattern) and writes its output, so every input is read once. A
call is that one kernel and one cudaMemsetAsync of its counters. Times on
the card: PERF.md, section 6 (``chip_smoke.py``,
``scripts/time_compressor_cuda.py``).

The backward (``compressor_fused_backward``) replaces the VJP at
comp_fused.py:167-176, which recomputed the forward through XLA's
associative scan. PyTorch has no scan whose autograd could stand in, so it
is a kernel too: the same single-pass scan on reversed time (2,048-sample
tiles, the row's partial tile first) of the envelope's cotangent u = dy *
out * ln10/20, which writes dx and dx_delayed; each tile writes its five
parameter partial sums, and the last tile of a row to finish adds them in
a fixed order, so the sums are deterministic. It needs the envelope g_s at
every sample; a forward that will be differentiated writes it (4 bytes a
sample more) rather than the backward recomputing it. The backward reads
x, x_delayed, g_s and dy and writes dx and dx_delayed: 24 bytes a sample.
``compressor_fused_gain`` is an ``autograd.Function`` over both halves; the
parameters' cotangents chain to ratio and the knee through ``_param_rows``.
Each call takes its own scratch (``torch.empty`` on the call's stream), so
calls on two streams do not share it.

The kernels clamp the knee to at least 1e-3 dB (comp_fused.py:151) so the
knee division never sees 0, and give it a cotangent only above 1e-3
(comp_fused.py:175). The Pallas kernel also set the knee of its padded lanes
to 1 (comp_fused.py:94-95); this kernel works on the rows as they are and
pads none.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from diffmst_torch.kernels._build import check_launch, differentiated, load_library
from diffmst_torch.kernels.scan1p import onepole_core_plain

__all__ = [
    "compressor_fused_gain",
    "compressor_fused_gain_plain",
    "compressor_fused_backward",
    "compressor_fused_backward_plain",
]

_LN10 = math.log(10.0)
_KNEE_MIN = 1e-3


def _param_rows(threshold_db, ratio, knee_db, alpha, makeup_db) -> torch.Tensor:
    """(5, B): threshold, 1/ratio - 1, knee, alpha, makeup. The kernels and
    the plain versions clamp the knee to at least 1e-3 themselves, and give
    it a cotangent only where it is above 1e-3, as the JAX VJP does."""
    return torch.stack([threshold_db, 1.0 / ratio - 1.0, knee_db, alpha, makeup_db], dim=0)


def _level_db(x: torch.Tensor, eps: float) -> torch.Tensor:
    return (20.0 / _LN10) * torch.log(torch.clamp(torch.abs(x), min=eps))


def _forward_plain(x, x_delayed, params, eps):
    """(out, envelope g_s) from the (5, B) parameter rows."""
    thr, irm1, knee, a, makeup = params[:, :, None]
    knee = torch.clamp(knee, min=_KNEE_MIN)
    over = _level_db(x, eps) - thr
    in_knee = irm1 * torch.square(over + knee * 0.5) / (2.0 * knee)
    above = irm1 * over
    g_c = torch.where(
        over <= -knee * 0.5,
        torch.zeros_like(over),
        torch.where(over >= knee * 0.5, above, in_knee),
    )
    g_s = onepole_core_plain((1.0 - a) * g_c, a[:, 0])
    return x_delayed * torch.exp((_LN10 / 20.0) * (g_s + makeup)), g_s


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
    params = _param_rows(threshold_db, ratio, knee_db, alpha, makeup_db)
    return _forward_plain(x, x_delayed, params, eps)[0]


def compressor_fused_backward_plain(x, x_delayed, params, envelope, dy, eps: float = 1e-8):
    """Plain PyTorch version of K2's backward, written out (no autograd):
    (dx, dx_delayed, dparams) for the cotangent dy of the output, with the
    forward's envelope g_s and its (5, B) parameter rows. dparams (5, B)
    holds the cotangents of the rows; its sums are taken in float64."""
    thr, irm1, knee_raw, a, makeup = params[:, :, None]
    knee = torch.clamp(knee_raw, min=_KNEE_MIN)
    gain = torch.exp((_LN10 / 20.0) * (envelope + makeup))
    dxd = dy * gain
    u = dxd * x_delayed * (_LN10 / 20.0)  # cotangent of g_s[n]
    s = onepole_core_plain(u.flip(-1), a[:, 0]).flip(-1)  # ... of the scan's state
    dg = (1.0 - a) * s  # ... of g_c[n]

    over = _level_db(x, eps) - thr
    w = over + knee * 0.5
    below, above = over <= -knee * 0.5, over >= knee * 0.5
    zero = torch.zeros_like(over)

    def knee_region(at_above, in_knee):
        return torch.where(below, zero, torch.where(above, at_above, in_knee))

    g_c = knee_region(irm1 * over, irm1 * (w * w) / (2.0 * knee))
    d_over = knee_region(irm1.expand_as(over), irm1 * w / knee)
    d_irm1 = knee_region(over, (w * w) / (2.0 * knee))
    d_knee = knee_region(zero, irm1 * w * (knee - w) / (2.0 * knee * knee))
    dx = torch.where(torch.abs(x) > eps, dg * d_over * (20.0 / _LN10) / x, zero)

    g_prev = F.pad(envelope[:, :-1], (1, 0))

    def row_sum(p, q):
        return (p.double() * q.double()).sum(dim=-1)

    dparams = torch.stack([
        -row_sum(dg, d_over),
        row_sum(dg, d_irm1),
        torch.where(knee_raw[:, 0] > _KNEE_MIN, row_sum(dg, d_knee), 0.0),
        row_sum(s, g_prev.double() - g_c.double()),
        u.double().sum(dim=-1),
    ]).to(x.dtype)
    return dx, dxd, dparams


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("comp_fused.cu")
    for fn in (lib.diffmst_compressor_scratch_bytes, lib.diffmst_compressor_backward_scratch_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    lib.diffmst_compressor_fused_gain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.diffmst_compressor_fused_gain.restype = ctypes.c_int
    lib.diffmst_compressor_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.diffmst_compressor_backward.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, x_delayed: torch.Tensor, params: torch.Tensor, *more) -> None:
    """x, x_delayed (B, T), params (5, B); ``more`` tensors shaped as x."""
    named = (("x", x), ("x_delayed", x_delayed), ("params", params)) + tuple(
        (f"input {i + 4}", t) for i, t in enumerate(more)
    )
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"compressor_fused_gain takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"compressor_fused_gain takes a contiguous {name}")
    if (
        x.ndim != 2
        or x_delayed.shape != x.shape
        or params.shape != (5, x.shape[0])
        or any(t.shape != x.shape for t in more)
    ):
        raise ValueError(
            f"compressor_fused_gain takes x, x_delayed (B, T) and (B,) parameters; got "
            f"{tuple(x.shape)}, {tuple(x_delayed.shape)}, params {tuple(params.shape)}"
        )
    if x.device.type != "cuda":
        raise ValueError(f"the compressor_fused_gain kernel runs on a CUDA device, not {x.device}")


def _launch(x, x_delayed, params, eps: float, envelope: bool):
    """(out, g_s or None): the envelope is written only when asked for."""
    _check(x, x_delayed, params)
    out = torch.empty_like(x)
    env = torch.empty_like(x) if envelope else None
    if x.numel() == 0:
        return out, env
    rows, t = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(
            lib.diffmst_compressor_scratch_bytes(rows, t), dtype=torch.uint8, device=x.device
        )
        err = lib.diffmst_compressor_fused_gain(
            x.data_ptr(), x_delayed.data_ptr(), params.data_ptr(), out.data_ptr(),
            None if env is None else env.data_ptr(), scratch.data_ptr(), rows, t, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "compressor_fused_gain")
    compressor_fused_gain.launches += 1
    return out, env


def _launch_backward(x, x_delayed, params, envelope, dy, eps: float):
    _check(x, x_delayed, params, envelope, dy)
    dx = torch.empty_like(x)
    dxd = torch.empty_like(x)
    dparams = torch.empty_like(params)
    if x.numel() == 0:
        return dx, dxd, dparams.zero_()
    rows, t = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(
            lib.diffmst_compressor_backward_scratch_bytes(rows, t), dtype=torch.uint8,
            device=x.device,
        )
        err = lib.diffmst_compressor_backward(
            x.data_ptr(), x_delayed.data_ptr(), params.data_ptr(), envelope.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dxd.data_ptr(), dparams.data_ptr(),
            scratch.data_ptr(), rows, t, eps, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "compressor_fused_backward")
    compressor_fused_backward.launches += 1
    return dx, dxd, dparams


class _Compressor(torch.autograd.Function):
    """K2 with its backward; ``plain`` picks the plain versions of both."""

    @staticmethod
    def forward(ctx, x, x_delayed, params, eps: float, plain: bool):
        differentiated = any(ctx.needs_input_grad[:3])
        if plain:
            out, env = _forward_plain(x, x_delayed, params, eps)
        else:
            out, env = _launch(x, x_delayed, params, eps, envelope=differentiated)
        ctx.eps, ctx.plain = eps, plain
        if differentiated:
            ctx.save_for_backward(x, x_delayed, params, env)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, x_delayed, params, env = ctx.saved_tensors
        backward = compressor_fused_backward_plain if ctx.plain else _launch_backward
        dx, dxd, dparams = backward(x, x_delayed, params, env, dy.contiguous(), ctx.eps)
        return dx, dxd, dparams, None, None


@torch.library.custom_op("diffmst::compressor_fused_gain", mutates_args=(), device_types="cuda")
def _compressor_op(x: torch.Tensor, x_delayed: torch.Tensor, params: torch.Tensor, eps: float) -> torch.Tensor:
    """K2's forward as an operator that ``torch.export`` can trace: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return _launch(x, x_delayed, params, eps, envelope=False)[0]


@_compressor_op.register_kernel("cpu")
def _(x, x_delayed, params, eps):
    return _forward_plain(x, x_delayed, params, eps)[0]


@_compressor_op.register_fake
def _(x, x_delayed, params, eps):
    return torch.empty_like(x)


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
    """Compressed x_delayed, gain detected on x; differentiable in all seven
    tensors. CPU tensors take the plain versions, CUDA tensors the kernels.
    A call that autograd does not record goes through the operator
    ``torch.ops.diffmst.compressor_fused_gain``."""
    params = _param_rows(threshold_db, ratio, knee_db, alpha, makeup_db).contiguous()
    if not differentiated(x, x_delayed, params):
        return _compressor_op(x, x_delayed, params, eps)
    return _Compressor.apply(x, x_delayed, params, eps, x.device.type == "cpu")


def compressor_fused_backward(x, x_delayed, params, envelope, dy, eps: float = 1e-8):
    """(dx, dx_delayed, dparams) of K2 for the cotangent dy, from the
    forward's inputs, its (5, B) parameter rows and its envelope g_s. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return compressor_fused_backward_plain(x, x_delayed, params, envelope, dy, eps)
    return _launch_backward(x, x_delayed, params, envelope, dy, eps)


# Kernel launches (CUDA calls only); callers reset them to 0 to count a run.
compressor_fused_gain.launches = 0
compressor_fused_backward.launches = 0
