"""K5: the causal biquad cascade (``scipy.signal.sosfilt``), and its backward.

``sosfilt(x, sos_b, sos_a)`` filters (B, T) float32 rows through S biquad
sections in transposed direct form II from zero state; ``sos_b`` and
``sos_a`` are (B, S, 3) normalized coefficients (a0 = 1, not read). It is
the causal EQ (``ops/eq.py``, methods ``"scan"`` and ``"scan_pallas"``).

Replaces the Pallas kernel ``diffmst_tpu/kernels/iir_fused.py::_core``
(pallas_call at iir_fused.py:128; public ``sosfilt_pallas``:144). Kernel:
``csrc/iir_fused.cu``, a hand-written CUDA kernel for Hopper (sm_90a),
loaded with ctypes. Bound on the card: memory. The least traffic is read x
+ write y, 8 bytes a sample (20.0 us at 32 x 262,144 on an H100 SXM); the
arithmetic, 9 float64 operations a sample and section (54 in all), takes
13 us at the card's 34 TFLOP/s. The Pallas kernel kept the cascade in
VMEM, one pass over HBM.
The kernel treats the S sections of a row as one linear time-invariant
system on the 2S-vector of their TDF-II states and takes three launches
for all of them: a chunk pass runs the cascade over each 4,096-sample
chunk from a zero state and writes the chunk's end state; a carry pass
runs each row's chunks in order, carry[c+1] = A^4096 carry[c] + end[c];
an apply pass reruns the cascade from each chunk's carry and writes y
(and, when asked, the stages). Inside a chunk each section is a block
scan that carries 2-vectors only, since the section's matrix M is
constant along the row and the map of L samples is M^L. It moves 12 bytes
a sample (x read twice, y written), 32 with the five stages, and composes
in float64, each section's output rounded to float32 as the Pallas kernel
rounds between sections. A float32 scan is wrong by O(1) at the console's
20 Hz high-Q low shelf (ops/iir.py); float64 holds it. Times: PERF.md
(``chip_smoke.py`` [kernels]).

The backward, ``sosfilt_backward``, replaces the VJP at
iir_fused.py:167-170, which differentiated the XLA scan ``sosfilt_scan``.
Per section, backwards in time: the input's cotangent du is the output's
cotangent dy through the same TDF-II filter on reversed time, and the five
coefficient cotangents are sum_n w[n] u[n-k] (b_k) and -sum_n w[n] y[n-k]
(a_1, a_2) per row, summed deterministically, with w[n] = dy[n] - a1 w[n+1]
- a2 w[n+2]. w grows like 1/(1-r)^2 at a pole of radius r; du taken from it
as b0 w[n] + b1 w[n+1] + b2 w[n+2] would cancel that growth and lose digits
(3.8e-5 of du's peak at the console's 20 Hz shelf, r = 0.9998, in float64),
so du keeps its own recurrence. The sections taken in reverse order are one
linear time-invariant system on 4S states a row (du's and w's pairs per
section), and the kernel runs the forward's three passes on it in reversed
time: a chunk pass (every section over each chunk from a zero state, the
4S end state), a carry pass on the 4S-vector, an apply pass that reruns
each chunk from its carry, writes dx and adds the sums in float64 per
chunk; a fourth launch adds each row's partials in chunk order. Each
section's du is rounded to float32 before the next section, as the plain
version rounds. 4S fits the carry's 32-wide state up to eight sections;
more run in groups of eight (three launches a group). It moves 40 bytes a
sample (dy read twice; x, the five stages and y read once; dx written)
against the 36 that bound it. It needs every section's input: a forward
whose inputs need gradients writes them (``stages``, S - 1 rows of float32
signals: 5 x 16.8 MB for the training step's 32 track rows of 131,072
samples) rather than the backward recomputing them; a forward that is not
differentiated writes none. The gradient of a0 is 0, as in JAX, where it
is unused.

On a CPU tensor each wrapper runs its plain PyTorch version (``ops/iir.py``
and ``sosfilt_backward_plain``); on a CUDA tensor it launches the kernel or
raises. A wrapper call counts as one launch, whatever the number of CUDA
kernels it starts (three forward; four backward at up to eight sections,
seven at nine to sixteen).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from diffmst_torch.kernels._build import check_launch, differentiated, load_library
from diffmst_torch.ops.iir import biquad_scan, lti2_scan

__all__ = ["sosfilt", "sosfilt_plain", "sosfilt_backward", "sosfilt_backward_plain"]

_COEFS = 5  # per section and row: b0, b1, b2, a1, a2
_MAX_SECTIONS = 16  # the kernels' limit: the forward's 2S-vector fits a warp
_GROUP = 8  # sections a backward group: its 4S-vector fits the same width


def _coef_rows(sos_b: torch.Tensor, sos_a: torch.Tensor) -> torch.Tensor:
    """(S, 5, B): b0, b1, b2, a1, a2 of each section, row-major per row."""
    c = torch.stack([sos_b[..., 0], sos_b[..., 1], sos_b[..., 2], sos_a[..., 1], sos_a[..., 2]])
    return c.permute(2, 0, 1).contiguous()


def _forward_plain(x: torch.Tensor, coef: torch.Tensor):
    """(y, stages): the cascade through ``ops/iir.py::biquad_scan`` from the
    (S, 5, B) coefficient rows; stages holds every section's output but the
    last."""
    outs = []
    y = x
    for c in coef:
        a = torch.stack([torch.ones_like(c[3]), c[3], c[4]], dim=-1)
        y = biquad_scan(y, c[:3].t(), a)
        outs.append(y)
    stages = torch.stack(outs[:-1]) if len(outs) > 1 else x.new_empty((0, *x.shape))
    return y, stages


def sosfilt_plain(x: torch.Tensor, sos_b: torch.Tensor, sos_a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: each section a chunked Hillis-Steele scan
    of 2x2 affine maps in float64, rounded to x's type (``ops/iir.py``)."""
    return _forward_plain(x, _coef_rows(sos_b, sos_a))[0]


def _delay(v: torch.Tensor, k: int) -> torch.Tensor:
    """v[n - k] along the last axis, zeros before the start."""
    return F.pad(v, (k, 0))[..., : v.shape[-1]]


def sosfilt_backward_plain(x, stages, y, coef, dy):
    """Plain PyTorch version of K5's backward: (dx, dcoef) for the output y
    and its cotangent dy, from the forward's input x, its stages and its
    (S, 5, B) coefficient rows; dcoef holds the cotangents of b0, b1, b2, a1
    and a2. Per section, as the kernel: the input's cotangent is the
    section's TDF-II filter run on time-reversed rows (``biquad_scan``), and
    the coefficients' come from w = dy through 1/A backwards, a 2x2 scan of
    time-reversed rows in float64, with float64 row sums."""
    n_sec = coef.shape[0]
    dcoef = torch.empty(coef.shape, dtype=torch.float64, device=coef.device)
    d = dy
    for s in reversed(range(n_sec)):
        u = (x if s == 0 else stages[s - 1]).double()
        out = (y if s == n_sec - 1 else stages[s]).double()
        c = coef[s]
        a = torch.stack([torch.ones_like(c[3]), c[3], c[4]], dim=-1)
        a1, a2 = (r[:, None] for r in c[3:].double())
        m = torch.stack([torch.cat([-a1, -a2], -1), torch.cat([torch.ones_like(a1), torch.zeros_like(a1)], -1)], 1)
        d_rev = d.flip(-1).double()
        w_rev, _ = lti2_scan(m, d_rev, torch.zeros_like(d_rev))
        w = w_rev.flip(-1)  # w[n] = d[n] - a1 w[n+1] - a2 w[n+2]
        dcoef[s] = torch.stack([
            (w * u).sum(-1),
            (w * _delay(u, 1)).sum(-1),
            (w * _delay(u, 2)).sum(-1),
            -(w * _delay(out, 1)).sum(-1),
            -(w * _delay(out, 2)).sum(-1),
        ])
        d = biquad_scan(d.flip(-1), c[:3].t(), a).flip(-1)
    return d, dcoef.to(coef.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("iir_fused.cu")
    lib.diffmst_sosfilt_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.diffmst_sosfilt_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_sosfilt_backward_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.diffmst_sosfilt_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_sosfilt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.diffmst_sosfilt.restype = ctypes.c_int
    lib.diffmst_sosfilt_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.diffmst_sosfilt_backward.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, coef: torch.Tensor, *more: torch.Tensor) -> None:
    """x (B, T), coef (S, 5, B); ``more`` tensors shaped as x, or (S - 1, B,
    T) for the stages."""
    named = (("x", x), ("coef", coef)) + tuple((f"input {i + 3}", t) for i, t in enumerate(more))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"sosfilt takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"sosfilt takes a contiguous {name}")
    stage_shape = (coef.shape[0] - 1, *x.shape) if coef.ndim == 3 else None
    if (
        x.ndim != 2
        or coef.ndim != 3
        or coef.shape[0] < 1
        or coef.shape[1:] != (_COEFS, x.shape[0])
        or any(t.shape not in (x.shape, stage_shape) for t in more)
    ):
        raise ValueError(
            f"sosfilt takes x (B, T) and coefficients (S, 5, B); got {tuple(x.shape)}, "
            f"{tuple(coef.shape)} and {[tuple(t.shape) for t in more]}"
        )
    if x.shape[0] > 65535:
        raise ValueError(f"sosfilt takes at most 65535 rows, got {x.shape[0]}")
    if coef.shape[0] > _MAX_SECTIONS:
        raise ValueError(f"the sosfilt kernels take at most {_MAX_SECTIONS} sections, got {coef.shape[0]}")
    if x.device.type != "cuda":
        raise ValueError(f"the sosfilt kernel runs on a CUDA device, not {x.device}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch(x: torch.Tensor, coef: torch.Tensor, *, keep_stages: bool = True, events=None):
    """(y, stages) of the cascade on the card; with ``keep_stages`` False the
    kernel writes no stages and ``stages`` is empty. ``events``: four
    recorded ``torch.cuda.Event``s with timing, which the call records again
    before its chunk pass and after each of its three passes."""
    _check(x, coef)
    n_sec = coef.shape[0]
    y = torch.empty_like(x)
    stages = x.new_empty((n_sec - 1 if keep_stages else 0, *x.shape))
    if x.numel() == 0:
        return y, stages
    rows, t = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(
            lib.diffmst_sosfilt_scratch_bytes(rows, t, n_sec), dtype=torch.uint8, device=x.device
        )
        marks = None if events is None else (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
        err = lib.diffmst_sosfilt(
            x.data_ptr(), coef.data_ptr(), stages.data_ptr() if stages.numel() else None,
            y.data_ptr(), scratch.data_ptr(), rows, t, n_sec, _stream(), marks,
        )
    check_launch(lib, err, "sosfilt")
    sosfilt.launches += 1
    return y, stages


def _launch_backward(x, stages, y, coef, dy, *, events=None):
    """(dx, dcoef) on the card. ``events``: five recorded
    ``torch.cuda.Event``s with timing, which the call records again before
    its chunk pass and after each of its four launches (at up to eight
    sections)."""
    _check(x, coef, stages, y, dy)
    n_sec = coef.shape[0]
    if events is not None and n_sec > _GROUP:
        raise ValueError(f"pass events are recorded at up to {_GROUP} sections, got {n_sec}")
    dx = torch.empty_like(x)
    dcoef = torch.empty_like(coef)
    if x.numel() == 0:
        return dx, dcoef.zero_()
    rows, t = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        work = torch.empty_like(x) if n_sec > _GROUP else None
        scratch = torch.empty(
            lib.diffmst_sosfilt_backward_scratch_bytes(rows, t, n_sec), dtype=torch.uint8,
            device=x.device,
        )
        marks = None if events is None else (ctypes.c_void_p * 5)(*(e.cuda_event for e in events))
        err = lib.diffmst_sosfilt_backward(
            x.data_ptr(), stages.data_ptr() if n_sec > 1 else None, y.data_ptr(), coef.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), None if work is None else work.data_ptr(),
            dcoef.data_ptr(), scratch.data_ptr(), rows, t, n_sec, _stream(), marks,
        )
    check_launch(lib, err, "sosfilt_backward")
    sosfilt_backward.launches += 1
    return dx, dcoef


class _Sosfilt(torch.autograd.Function):
    """K5 with its backward; ``plain`` picks the plain versions of both."""

    @staticmethod
    def forward(ctx, x, coef, plain: bool):
        differentiated = any(ctx.needs_input_grad[:2])
        y, stages = _forward_plain(x, coef) if plain else _launch(x, coef, keep_stages=differentiated)
        ctx.plain = plain
        if differentiated:
            ctx.save_for_backward(x, coef, stages, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, coef, stages, y = ctx.saved_tensors
        backward = sosfilt_backward_plain if ctx.plain else _launch_backward
        dx, dcoef = backward(x, stages, y, coef, dy.contiguous())
        return dx, dcoef, None


@torch.library.custom_op("diffmst::sosfilt", mutates_args=(), device_types="cuda")
def _sosfilt_op(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """K5's forward from the (S, 5, B) coefficient rows as an operator that
    ``torch.export`` can trace: the kernel on CUDA tensors (no stages
    written), the plain version on CPU tensors."""
    return _launch(x, coef, keep_stages=False)[0]


@_sosfilt_op.register_kernel("cpu")
def _(x, coef):
    return _forward_plain(x, coef)[0]


@_sosfilt_op.register_fake
def _(x, coef):
    return torch.empty_like(x)


def sosfilt(x: torch.Tensor, sos_b: torch.Tensor, sos_a: torch.Tensor) -> torch.Tensor:
    """The cascade of the (B, S, 3) sections over x (B, T) from zero state;
    differentiable in x, sos_b and sos_a. CPU tensors take the plain
    versions, CUDA tensors the kernels. A call that autograd does not record
    goes through the operator ``torch.ops.diffmst.sosfilt``."""
    coef = _coef_rows(sos_b, sos_a)
    if not differentiated(x, coef):
        return _sosfilt_op(x, coef)
    return _Sosfilt.apply(x, coef, x.device.type == "cpu")


def sosfilt_backward(x, stages, y, coef, dy):
    """(dx, dcoef) of the cascade for the cotangent dy, from the forward's
    input x, stages and output y and its (S, 5, B) coefficient rows. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return sosfilt_backward_plain(x, stages, y, coef, dy)
    return _launch_backward(x, stages, y, coef, dy)


# Wrapper calls that launched the kernels (CUDA only); callers reset them to
# 0 to count a run.
sosfilt.launches = 0
sosfilt_backward.launches = 0
