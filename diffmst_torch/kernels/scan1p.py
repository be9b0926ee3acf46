"""K1: first-order linear recurrence (one-pole) scan along time, and its backward.

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
to 128). On the GPU one block per row would occupy 8-32 of 132 SMs, so with
a row's alpha the kernel is the single-pass scan with decoupled look-back of
``csrc/lookback.cuh``, as K2's: each block takes a tile of a row from an
atomic ticket, copies b into shared memory with cp.async, scans it from zero
in float64, takes the state entering it from the tiles before it (their
aggregates' one word, B, published over a fill pattern) and writes y, so b
is read once. A call is that one kernel and one cudaMemsetAsync of its
counters. It composes the maps in float64 and rounds once, as float32, so a
pole near 1 costs it no accuracy. On an NVIDIA H100 80GB HBM3 at 700 W it
takes 0.039 ms at 32 x 262,144 (1.7 TB/s, twice the bound; the three-pass
scan took 0.120) and 0.017 ms at 8 x 262,144 (PERF.md, section 6;
``chip_smoke.py``, ``scripts/time_scan1p_cuda.py``). With a
per-sample alpha (K4, on no path) the multiplicative part of a tile's map
is the product of its alphas, which no reader can compute from a pole: the
same kernel stages b and alpha (32 KB a tile of 4,096), each sample's alpha
is its map's coefficient, and the tiles publish two words, A and B (the
driver's ``GatedAffine``). A product of small alphas underflows to 0, which
is right to double precision: the earlier state's weight is below 1e-308.
It reads b and alpha and writes y, 12 bytes a sample, once each: 100.7 MB
at 32 x 262,144, a bound of 30.0 us. On an NVIDIA H100 80GB HBM3 at 700 W
it takes 0.052 ms there (1.9 TB/s, 1.7 times the bound; the three-pass
scan it replaced took 0.134) and 0.022 ms at 8 x 262,144.

The backward, ``onepole_core_backward(dy, alpha, y)``, replaces the VJPs of
``onepole_scan`` (scan1p.py:142-150) and of ``onepole_scan_tv`` (K4,
scan1p.py:176-187), which launched the Pallas scan on time-reversed rows.
The adjoint s[n] = dy[n] + a[n+1] * s[n+1] is the same scan run backwards
in time: db = s, and dalpha = s[n] * y[n-1] per sample, or its sum over
the row. It reads dy and y and writes db, 12 bytes a sample (20 with a
per-sample alpha). With a row's alpha it is the same single-pass look-back
kernel as K1's, walking each row's tiles from its end: dy staged before
the scan and y after, one carried word, the sums added per thread, per
tile, then by the row's last tile in a fixed order; one kernel and one
cudaMemsetAsync a call. On an NVIDIA H100 80GB HBM3 at 700 W it takes
0.036 ms at 32 x 131,072 (1.4 TB/s, 2.4 times the bound; the three-pass
scan took 0.078) and 0.018 ms at 8 x 131,072 (PERF.md, section 6). With a
per-sample alpha (K4's backward) the coefficient of sample n is the next
sample's alpha, read past the thread's last item from the tile and past
the tile's end from device memory (the row's last sample's multiplies the
zero state and is 0); dy and alpha are staged before the scan and y after
(48 KB a tile), the tiles carry (A, B) as K4's do, and db and dalpha (per
sample) are written in dy's and alpha's slots of the tile. It reads dy,
alpha and y and writes db and dalpha, 20 bytes a sample: 83.9 MB at 32 x
131,072, a bound of 25.0 us. On an NVIDIA H100 80GB HBM3 at 700 W it
takes 0.044 ms there (1.9 TB/s, 1.8 times the bound; the three-pass scan
took 0.124) and 0.019 ms at 8 x 131,072. Every one of these kernels takes
any number of rows. ``onepole_core`` is an ``autograd.Function`` over both
halves.

K3, ``release_min_scan(g, alpha)``, is the release stage of the decoupled
compressor: y[n] = min(g[n], a * y[n-1] + (1 - a) * g[n]) from y[-1] = 0 dB,
with g (B, T) float32 gains in dB and alpha (B,). It replaces the Pallas
kernel ``diffmst_tpu/kernels/scan1p.py::minscan_core`` (pallas_call at
scan1p.py:253) behind ``release_min_scan``:270. The maps y -> min(c, a*y +
d) compose associatively as (A, D, C) (scan1p.py:196-199), so K3 is the
same single-pass look-back scan over a min-affine map, whose tiles publish
two words, D and C (A is alpha to the tile's length, which each reader
computes). It composes in float64 and rounds once: a float32 composition
drifts at a = 0.9998 as K1's does. Where a small pole's powers underflow
to 0, the composition takes ``fmin`` with the product of 0 and an
identity's C = +inf, which drops that NaN. It reads g and writes y, 8 bytes a sample (20.0 us at 32 x 262,144 on
an H100 SXM); on an NVIDIA H100 80GB HBM3 at 700 W it takes 0.047 ms there
(1.4 TB/s; the three-pass scan took 0.121) and 0.021 ms at 8 x 262,144. Its
map's three doubles cost it registers (64, with a few spilled) and float64
work that K1's two do not.

Its backward, ``release_min_scan_backward(dy, g, alpha, y)``, replaces the
VJP at scan1p.py:294-297, which differentiated the XLA twin
``_minscan_ref``:277. y[n] takes the linear branch where L[n] = y[n-1] <
g[n] (y[-1] = 0) and equals g[n] elsewhere, ties included (JAX's ``min``
splits a tie's cotangent in halves instead). The adjoint is a reverse
one-pole with the per-sample coefficient a * L[n+1]: s[n] = dy[n] + a L[n+1]
s[n+1], dg = s ((1 - a) L + 1 - L), and dalpha = sum s L (y[n-1] - g[n]), a
row sum. It reads dy, y and g and writes dg, 16 bytes a sample. It is a
single-pass look-back kernel too, in reversed time, with dy, g and y staged
before the scan: a sample's coefficient needs the gate L[n+1], from y[n] and the
next sample's g (past a tile's end, from device memory). Its tiles' maps
have a multiplicative part that is a product of alphas and zeros, not
alpha to the tile's length, so each tile publishes two words, A and B. On
an NVIDIA H100 80GB HBM3 at 700 W it takes 0.045 ms at 32 x 131,072 (1.5
TB/s; the three-pass scan took 0.107) and 0.022 ms at 8 x 131,072.

On a CPU tensor each wrapper runs its plain PyTorch version
(``onepole_core_plain``, ``release_min_scan_plain`` and their backward
versions); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from diffmst_torch.kernels._build import check_launch, differentiated, load_library

__all__ = [
    "onepole_core",
    "onepole_core_plain",
    "onepole_core_backward",
    "onepole_core_backward_plain",
    "release_min_scan",
    "release_min_scan_plain",
    "release_min_scan_backward",
    "release_min_scan_backward_plain",
]


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


def _hillis_steele_maps(elems, combine, identity):
    """Inclusive scan along the last axis of maps given as a tuple of
    tensors; ``combine(earlier, later)`` composes two such tuples and
    ``identity`` holds each component's identity value."""
    n = elems[0].shape[-1]
    d = 1
    while d < n:
        prev = tuple(F.pad(e[..., :-d], (d, 0), value=v) for e, v in zip(elems, identity))
        elems = combine(prev, elems)
        d *= 2
    return elems


def _chunked_map_scan(elems, combine, identity, chunk: int = 512):
    """Inclusive scan of maps along the last axis, as the kernels take it: a
    Hillis-Steele scan inside each chunk of ``chunk`` samples, a scan of the
    chunk totals, and each chunk's prefix composed before its samples. The
    components are (B, T) tensors; compose in float64 for the kernels'
    numbers."""
    t = elems[0].shape[-1]
    n_chunks = -(-t // chunk)
    pad = n_chunks * chunk - t
    E = tuple(
        F.pad(e, (0, pad), value=v).reshape(*e.shape[:-1], n_chunks, chunk)
        for e, v in zip(elems, identity)
    )
    E = _hillis_steele_maps(E, combine, identity)
    totals = _hillis_steele_maps(tuple(e[..., -1] for e in E), combine, identity)
    before = tuple(F.pad(e[..., :-1], (1, 0), value=v)[..., None] for e, v in zip(totals, identity))
    E = combine(before, E)
    return tuple(e.reshape(*e.shape[:-2], n_chunks * chunk)[..., :t] for e in E)


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


def onepole_core_backward_plain(dy: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor):
    """Plain PyTorch version of K1's backward: (db, dalpha) for the output
    ``y`` and its cotangent ``dy``. The adjoint runs through
    ``onepole_core_plain`` on time-reversed rows, with a per-sample alpha's
    coefficients shifted by one (as scan1p.py:181-183); dalpha's products
    and row sums are taken in float64."""
    if alpha.ndim == 2:
        a_rev = alpha.flip(-1)
        a_rev = F.pad(a_rev[:, :-1], (1, 0), value=1.0)  # a[n+1]; the first is moot
    else:
        a_rev = alpha
    s = onepole_core_plain(dy.flip(-1), a_rev).flip(-1)
    y_prev = F.pad(y[:, :-1], (1, 0))
    prod = s.double() * y_prev.double()
    dalpha = prod if alpha.ndim == 2 else prod.sum(dim=-1)
    return s, dalpha.to(alpha.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("scan1p.cu")
    lib.diffmst_onepole_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.diffmst_onepole_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_onepole_backward_scratch_bytes.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ]
    lib.diffmst_onepole_backward_scratch_bytes.restype = ctypes.c_longlong
    lib.diffmst_onepole_core.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_onepole_core.restype = ctypes.c_int
    lib.diffmst_onepole_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_onepole_backward.restype = ctypes.c_int
    for fn in (lib.diffmst_minscan_scratch_bytes, lib.diffmst_minscan_backward_scratch_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
    lib.diffmst_release_min_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_release_min_scan.restype = ctypes.c_int
    lib.diffmst_release_min_scan_backward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_release_min_scan_backward.restype = ctypes.c_int
    return lib


def _check(b: torch.Tensor, alpha: torch.Tensor, *more: torch.Tensor) -> None:
    """``b`` (B, T) and ``alpha`` (B,) or (B, T); ``more`` tensors shaped as b."""
    if any(t.dtype != torch.float32 for t in (b, alpha, *more)):
        raise TypeError(f"onepole_core takes float32, got {b.dtype} and {alpha.dtype}")
    if b.ndim != 2 or alpha.shape not in ((b.shape[0],), tuple(b.shape)):
        raise ValueError(
            f"onepole_core takes b (B, T) and alpha (B,) or (B, T); got "
            f"{tuple(b.shape)} and {tuple(alpha.shape)}"
        )
    if any(t.shape != b.shape for t in more):
        raise ValueError(f"onepole_core_backward takes dy and y of b's shape {tuple(b.shape)}")
    if any(t.device != b.device for t in (alpha, *more)):
        raise ValueError(f"b on {b.device} but alpha, dy or y elsewhere")
    if not all(t.is_contiguous() for t in (b, alpha, *more)):
        raise ValueError("onepole_core takes contiguous tensors")
    if b.device.type != "cuda":
        raise ValueError(f"the onepole_core kernel runs on a CUDA device, not {b.device}")


def _check_rows(name: str, x: torch.Tensor, alpha: torch.Tensor, *more: torch.Tensor) -> None:
    """``x`` (B, T) float32 and ``alpha`` (B,) float32 on one CUDA device,
    contiguous; ``more`` tensors shaped as x."""
    if any(t.dtype != torch.float32 for t in (x, alpha, *more)):
        raise TypeError(f"{name} takes float32, got {[str(t.dtype) for t in (x, alpha, *more)]}")
    if x.ndim != 2 or alpha.shape != (x.shape[0],) or any(t.shape != x.shape for t in more):
        raise ValueError(
            f"{name} takes (B, T) rows and alpha (B,); got {tuple(x.shape)}, alpha "
            f"{tuple(alpha.shape)} and {[tuple(t.shape) for t in more]}"
        )
    if any(t.device != x.device for t in (alpha, *more)):
        raise ValueError(f"{name}: inputs on {[str(t.device) for t in (x, alpha, *more)]}")
    if not all(t.is_contiguous() for t in (x, alpha, *more)):
        raise ValueError(f"{name} takes contiguous tensors")
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on a CUDA device, not {x.device}")


def _launch(b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    _check(b, alpha)
    per_sample = alpha.ndim == 2
    y = torch.empty_like(b)
    if b.numel() == 0:
        return y
    rows, t = b.shape
    lib = _lib()
    with torch.cuda.device(b.device):
        scratch = torch.empty(
            lib.diffmst_onepole_scratch_bytes(rows, t, int(per_sample)), dtype=torch.uint8,
            device=b.device,
        )
        err = lib.diffmst_onepole_core(
            b.data_ptr(), alpha.data_ptr(), int(per_sample), y.data_ptr(),
            scratch.data_ptr(), rows, t, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "onepole_core")
    if per_sample:
        onepole_core.launches_per_sample += 1
    else:
        onepole_core.launches += 1
    return y


def _launch_backward(dy: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor):
    _check(dy, alpha, y)
    per_sample = alpha.ndim == 2
    db = torch.empty_like(dy)
    dalpha = torch.empty_like(alpha)
    if dy.numel() == 0:
        return db, dalpha.zero_()
    rows, t = dy.shape
    lib = _lib()
    with torch.cuda.device(dy.device):
        scratch = torch.empty(
            lib.diffmst_onepole_backward_scratch_bytes(rows, t, int(per_sample)),
            dtype=torch.uint8, device=dy.device,
        )
        err = lib.diffmst_onepole_backward(
            dy.data_ptr(), alpha.data_ptr(), int(per_sample), y.data_ptr(), db.data_ptr(),
            dalpha.data_ptr(), scratch.data_ptr(), rows, t,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "onepole_core_backward")
    if per_sample:
        onepole_core_backward.launches_per_sample += 1
    else:
        onepole_core_backward.launches += 1
    return db, dalpha


class _Onepole(torch.autograd.Function):
    """K1 with its backward; ``plain`` picks the plain versions of both."""

    @staticmethod
    def forward(ctx, b, alpha, plain: bool):
        y = onepole_core_plain(b, alpha) if plain else _launch(b, alpha)
        ctx.plain = plain
        ctx.save_for_backward(alpha, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        alpha, y = ctx.saved_tensors
        backward = onepole_core_backward_plain if ctx.plain else _launch_backward
        db, dalpha = backward(dy.contiguous(), alpha, y)
        return db, (dalpha if ctx.needs_input_grad[1] else None), None


@torch.library.custom_op("diffmst::onepole_core", mutates_args=(), device_types="cuda")
def _onepole_op(b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """K1's (K4's with a per-sample alpha) forward as an operator that
    ``torch.export`` can trace: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    return _launch(b, alpha)


@_onepole_op.register_kernel("cpu")
def _(b, alpha):
    return onepole_core_plain(b, alpha)


@_onepole_op.register_fake
def _(b, alpha):
    return torch.empty_like(b)


def onepole_core(b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """y[n] = alpha * y[n-1] + b[n] over the last axis of b (B, T); alpha (B,)
    or (B, T). Differentiable in b and alpha. CPU tensors take the plain
    versions, CUDA tensors the kernels. A call that autograd does not record
    goes through the operator ``torch.ops.diffmst.onepole_core``."""
    if not differentiated(b, alpha):
        return _onepole_op(b, alpha)
    return _Onepole.apply(b, alpha, b.device.type == "cpu")


def onepole_core_backward(dy: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor):
    """(db, dalpha) of ``y = onepole_core(b, alpha)`` for the cotangent dy:
    dalpha has alpha's shape. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if dy.device.type == "cpu":
        return onepole_core_backward_plain(dy, alpha, y)
    return _launch_backward(dy, alpha, y)


# ------------------------------------------------------------------ K3


def _min_affine(earlier, later):
    """(A, D, C) of y -> min(C, A*y + D): ``earlier`` then ``later``. fmin
    keeps the other bound where an underflowed A times an identity's +inf
    C gives NaN, as the kernel does."""
    a1, d1, c1 = earlier
    a2, d2, c2 = later
    return a1 * a2, a2 * d1 + d2, torch.fmin(c2, a2 * c1 + d2)


_MIN_AFFINE_IDENTITY = (1.0, 0.0, float("inf"))


def release_min_scan_plain(g: torch.Tensor, alpha: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of K3 (``diffmst_tpu/ops/compressor.py::
    _release_min_scan``:126): the chunked Hillis-Steele scan of the (A, D,
    C) maps in float64, applied to the 0 dB state entering the row (y =
    min(C, D), as scan1p.py:287), rounded once to g's type."""
    g64 = g.double()
    a = alpha.double()[:, None].expand_as(g64)
    _, D, C = _chunked_map_scan((a, (1.0 - a) * g64, g64), _min_affine, _MIN_AFFINE_IDENTITY, chunk)
    return torch.fmin(C, D).to(g.dtype)


def _linear_branch(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L[n] = y[n-1] < g[n], with y[-1] = 0: where K3 took a * y[n-1] +
    (1 - a) * g[n] rather than g[n]."""
    return F.pad(y[:, :-1], (1, 0)) < g


def release_min_scan_backward_plain(dy, g, alpha, y):
    """Plain PyTorch version of K3's backward: (dg, dalpha) for the output
    ``y`` and its cotangent ``dy``. The adjoint runs through
    ``onepole_core_plain`` on time-reversed rows with the coefficient
    a * L[n+1]; dalpha's products and row sums are taken in float64."""
    lin = _linear_branch(g, y)
    a = alpha[:, None]
    coef = torch.where(F.pad(lin[:, 1:], (0, 1), value=False), a, torch.zeros_like(a))
    s = onepole_core_plain(dy.flip(-1), coef.flip(-1).contiguous()).flip(-1)
    dg = torch.where(lin, (1.0 - a) * s, s)
    y_prev = F.pad(y[:, :-1], (1, 0))
    dalpha = torch.where(lin, s.double() * (y_prev.double() - g.double()), 0.0).sum(dim=-1)
    return dg, dalpha.to(alpha.dtype)


def _launch_minscan(g: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    _check_rows("release_min_scan", g, alpha)
    y = torch.empty_like(g)
    if g.numel() == 0:
        return y
    rows, t = g.shape
    lib = _lib()
    with torch.cuda.device(g.device):
        scratch = torch.empty(lib.diffmst_minscan_scratch_bytes(rows, t), dtype=torch.uint8, device=g.device)
        err = lib.diffmst_release_min_scan(
            g.data_ptr(), alpha.data_ptr(), y.data_ptr(), scratch.data_ptr(), rows, t,
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "release_min_scan")
    release_min_scan.launches += 1
    return y


def _launch_minscan_backward(dy, g, alpha, y):
    _check_rows("release_min_scan_backward", dy, alpha, g, y)
    dg = torch.empty_like(dy)
    dalpha = torch.empty_like(alpha)
    if dy.numel() == 0:
        return dg, dalpha.zero_()
    rows, t = dy.shape
    lib = _lib()
    with torch.cuda.device(dy.device):
        scratch = torch.empty(
            lib.diffmst_minscan_backward_scratch_bytes(rows, t), dtype=torch.uint8, device=dy.device
        )
        err = lib.diffmst_release_min_scan_backward(
            dy.data_ptr(), g.data_ptr(), alpha.data_ptr(), y.data_ptr(), dg.data_ptr(),
            dalpha.data_ptr(), scratch.data_ptr(), rows, t, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "release_min_scan_backward")
    release_min_scan_backward.launches += 1
    return dg, dalpha


class _MinScan(torch.autograd.Function):
    """K3 with its backward; ``plain`` picks the plain versions of both."""

    @staticmethod
    def forward(ctx, g, alpha, plain: bool):
        y = release_min_scan_plain(g, alpha) if plain else _launch_minscan(g, alpha)
        ctx.plain = plain
        ctx.save_for_backward(g, alpha, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        g, alpha, y = ctx.saved_tensors
        backward = release_min_scan_backward_plain if ctx.plain else _launch_minscan_backward
        dg, dalpha = backward(dy.contiguous(), g, alpha, y)
        return dg, (dalpha if ctx.needs_input_grad[1] else None), None


@torch.library.custom_op("diffmst::release_min_scan", mutates_args=(), device_types="cuda")
def _minscan_op(g: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """K3's forward as an operator that ``torch.export`` can trace: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return _launch_minscan(g, alpha)


@_minscan_op.register_kernel("cpu")
def _(g, alpha):
    return release_min_scan_plain(g, alpha)


@_minscan_op.register_fake
def _(g, alpha):
    return torch.empty_like(g)


def release_min_scan(g: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """y[n] = min(g[n], alpha * y[n-1] + (1 - alpha) * g[n]) over the last
    axis of g (B, T) from y[-1] = 0; alpha (B,). Differentiable in g and
    alpha. CPU tensors take the plain versions, CUDA tensors the kernels. A
    call that autograd does not record goes through the operator
    ``torch.ops.diffmst.release_min_scan``."""
    if not differentiated(g, alpha):
        return _minscan_op(g, alpha)
    return _MinScan.apply(g, alpha, g.device.type == "cpu")


def release_min_scan_backward(dy, g, alpha, y):
    """(dg, dalpha) of ``y = release_min_scan(g, alpha)`` for the cotangent
    dy. CPU tensors take the plain version, CUDA tensors the kernel."""
    if dy.device.type == "cpu":
        return release_min_scan_backward_plain(dy, g, alpha, y)
    return _launch_minscan_backward(dy, g, alpha, y)


# Kernel launches (CUDA calls only); callers reset them to 0 to count a run.
# K1 and its backward count their per-row (K1) and per-sample (K4) launches
# apart.
onepole_core.launches = 0
onepole_core.launches_per_sample = 0
onepole_core_backward.launches = 0
onepole_core_backward.launches_per_sample = 0
release_min_scan.launches = 0
release_min_scan_backward.launches = 0
