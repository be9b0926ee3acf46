"""The compressor's "ballistics" smoother, and its backward through K4's.

``ballistics(g, alpha_a, alpha_r)`` runs, over the last axis of (B, T)
float32 gains in dB from y[-1] = 0,

    a[n] = alpha_a if g[n] < y[n-1] else alpha_r
    y[n] = a[n] * y[n-1] + (1 - a[n]) * g[n]

with alpha_a and alpha_r (B,): the attack pole while the gain dips below
the state, the release pole while it recovers. It replaces
``diffmst_tpu/ops/compressor.py::_smooth_ballistics`` (:161), a sequential
``lax.scan``; no Pallas kernel computed it. The pole depends on y[n-1], so
no associative scan can run it. The kernel (``csrc/ballistics.cu``) is one
thread a row walking time, the state carried in float64 and stored as
float32; it is bound by the latency of its T dependent steps, not by its 8
bytes a sample.

Where autograd records the call, the kernel also writes the coefficient
a[n] it chose and the branch it took. The backward is then K4's backward
kernel (``scan1p.onepole_core_backward`` with a per-sample alpha) on a[n]:
it gives s = dL/db for b[n] = (1 - a[n]) g[n] and dalpha[n] = s[n] y[n-1];
then dg = (1 - a) s, da = dalpha - s g, and alpha_a's and alpha_r's
gradients are da's row sums where attack and where release was taken. The
branch carries no gradient, as in JAX, and the backward uses the forward's
own decisions, never ones recomputed from the rounded y.

On a CPU tensor the wrappers run the plain versions (``ballistics_plain``:
a loop over time of row-vector operations in float64, rounded once to the
input's type; the backward through ``onepole_core_backward_plain``); on a
CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffmst_torch.kernels._build import check_launch, differentiated, load_library
from diffmst_torch.kernels.scan1p import _check_rows, onepole_core_backward, onepole_core_backward_plain

__all__ = ["ballistics", "ballistics_plain", "ballistics_backward", "ballistics_backward_plain"]


def ballistics_plain(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor,
                     record: bool = False):
    """Plain PyTorch version of the kernel: a loop over time of operations
    on the rows, the state in float64 (as the kernel carries it), y rounded
    once to g's type. With ``record`` it returns (y, a, attack): the
    coefficient chosen per sample, in alpha_a's type, and the branch."""
    aa, ar = alpha_a.double(), alpha_r.double()
    state = torch.zeros(g.shape[0], dtype=torch.float64, device=g.device)
    ys, attacks = [], []
    for gn in g.double().unbind(-1):
        d = state - gn
        attack = d > 0  # g[n] < y[n-1]
        state = torch.addcmul(gn, torch.where(attack, aa, ar), d)  # a y + (1 - a) g
        ys.append(state)
        attacks.append(attack)
    y = torch.stack(ys, dim=-1).to(g.dtype) if ys else torch.empty_like(g)
    if not record:
        return y
    attack = torch.stack(attacks, dim=-1) if attacks else torch.zeros_like(g, dtype=torch.bool)
    a = torch.where(attack, alpha_a[:, None], alpha_r[:, None])
    return y, a, attack


def _compose_backward(dy, g, y, a, attack, core_backward):
    """(dg, dalpha_a, dalpha_r) from the one-pole backward ``core_backward``
    on the per-sample coefficients; the row sums in float64."""
    s, dalpha = core_backward(dy, a, y)
    dg = (1.0 - a) * s
    da = dalpha.double() - s.double() * g.double()
    zero = torch.zeros((), dtype=torch.float64, device=da.device)
    d_attack = torch.where(attack, da, zero).sum(dim=-1)
    d_release = torch.where(attack, zero, da).sum(dim=-1)
    return dg, d_attack.to(a.dtype), d_release.to(a.dtype)


def ballistics_backward_plain(dy, g, y, a, attack):
    """Plain PyTorch version of the backward: (dg, dalpha_a, dalpha_r)
    through ``onepole_core_backward_plain``."""
    return _compose_backward(dy, g, y, a, attack, onepole_core_backward_plain)


def ballistics_backward(dy, g, y, a, attack):
    """(dg, dalpha_a, dalpha_r) of ``y = ballistics(g, alpha_a, alpha_r)``
    for the cotangent dy, from the forward's coefficients ``a`` and branches
    ``attack``: K4's backward kernel and elementwise operations on a CUDA
    tensor, the plain versions on a CPU tensor."""
    if dy.device.type == "cpu":
        return ballistics_backward_plain(dy, g, y, a, attack)
    return _compose_backward(dy, g, y, a, attack, onepole_core_backward)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("ballistics.cu")
    lib.diffmst_ballistics.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.diffmst_ballistics.restype = ctypes.c_int
    lib.diffmst_ballistics_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.diffmst_ballistics_chain.restype = ctypes.c_int
    return lib


def _launch(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor, record: bool = False):
    """The kernel's y; with ``record`` (y, a, attack) as the plain version's."""
    _check_rows("ballistics", g, alpha_a)
    _check_rows("ballistics", g, alpha_r)
    y = torch.empty_like(g)
    a = torch.empty_like(g) if record else None
    attack = torch.empty(g.shape, dtype=torch.bool, device=g.device) if record else None
    rows, t = g.shape
    lib = _lib()
    with torch.cuda.device(g.device):
        err = lib.diffmst_ballistics(
            g.data_ptr(), alpha_a.data_ptr(), alpha_r.data_ptr(), y.data_ptr(),
            a.data_ptr() if record else None, attack.data_ptr() if record else None,
            rows, t, torch.cuda.current_stream().cuda_stream,
        )
    check_launch(lib, err, "ballistics")
    if g.numel():
        ballistics.launches += 1
    return (y, a, attack) if record else y


def chain_seconds(steps: int, alpha_a: float, alpha_r: float) -> float:
    """Seconds one CUDA thread takes for ``steps`` dependent ballistics
    steps on values in registers (``ballistics_chain``, on no path): the
    recurrence's latency bound, timed with CUDA events on the current
    device after one warm call."""
    lib = _lib()
    out = torch.empty(2, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream()
    check_launch(lib, lib.diffmst_ballistics_chain(out.data_ptr(), 1024, alpha_a, alpha_r,
                                                   stream.cuda_stream), "ballistics_chain")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    check_launch(lib, lib.diffmst_ballistics_chain(out.data_ptr(), steps, alpha_a, alpha_r,
                                                   stream.cuda_stream), "ballistics_chain")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


class _Ballistics(torch.autograd.Function):
    """The kernel with its backward; ``plain`` picks the plain versions."""

    @staticmethod
    def forward(ctx, g, alpha_a, alpha_r, plain: bool):
        forward = ballistics_plain if plain else _launch
        y, a, attack = forward(g, alpha_a, alpha_r, record=True)
        ctx.plain = plain
        ctx.save_for_backward(g, y, a, attack)
        return y

    @staticmethod
    def backward(ctx, dy):
        g, y, a, attack = ctx.saved_tensors
        backward = ballistics_backward_plain if ctx.plain else ballistics_backward
        dg, d_attack, d_release = backward(dy.contiguous(), g, y, a, attack)
        return dg, d_attack, d_release, None


@torch.library.custom_op("diffmst::ballistics", mutates_args=(), device_types="cuda")
def _ballistics_op(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor) -> torch.Tensor:
    """The forward as an operator that ``torch.export`` can trace: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    return _launch(g, alpha_a, alpha_r)


@_ballistics_op.register_kernel("cpu")
def _(g, alpha_a, alpha_r):
    return ballistics_plain(g, alpha_a, alpha_r)


@_ballistics_op.register_fake
def _(g, alpha_a, alpha_r):
    return torch.empty_like(g)


def ballistics(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor) -> torch.Tensor:
    """The attack/release smoother of g (B, T) from y[-1] = 0, alphas (B,).
    Differentiable in g and both alphas. CPU tensors take the plain
    versions, CUDA tensors the kernels. A call that autograd does not
    record goes through the operator ``torch.ops.diffmst.ballistics``."""
    if not differentiated(g, alpha_a, alpha_r):
        return _ballistics_op(g, alpha_a, alpha_r)
    return _Ballistics.apply(g, alpha_a, alpha_r, g.device.type == "cpu")


# Kernel launches (CUDA calls only); callers reset it to 0 to count a run.
# The backward's launches are K4's backward kernel's
# (scan1p.onepole_core_backward.launches_per_sample).
ballistics.launches = 0
