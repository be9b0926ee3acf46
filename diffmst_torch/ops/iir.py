"""Exact causal IIR filtering as scans: the biquad cascade's plain version.

Port of ``diffmst_tpu/ops/iir.py``. A biquad in transposed direct form II,

    y[n]  = b0 x[n] + s1[n-1]
    s1[n] = (b1 - a1 b0) x[n] - a1 s1[n-1] + s2[n-1]
    s2[n] = (b2 - a2 b0) x[n] - a2 s1[n-1]

is a first-order affine recurrence on the state v = (s1, s2),
v[n] = M v[n-1] + u[n] with M = [[-a1, 1], [-a2, 0]], and the 2x2 affine maps
(M, u) compose associatively (ops/iir.py:46-58): ``lti2_scan``.
``sosfilt_scan`` applies a cascade of sections from zero state:
``scipy.signal.sosfilt``'s semantics.

Unlike the JAX module, which scans in the input's float32, the maps are
composed in float64 and each section's output is rounded once to the input's
type. A float32 scan's error grows like eps / (1 - r)^2 with the pole radius
r (about 2e-3 at r = 0.9988, O(1) at 0.9996, a 20-30 Hz high-Q shelf); in
float64 it stays below 1e-6 of the peak there. This module is the plain
version of kernel K5 (``kernels/iir_fused.py``), whose CUDA scan composes
the same maps in double.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["biquad_scan", "sosfilt_scan", "lti2_scan"]

def lti2_scan(m: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor, chunk: int = 32):
    """The states v[n] = M v[n-1] + (u1[n], u2[n]) from v[-1] = 0 along the
    last axis, with one 2x2 matrix M per row (m: (B, 2, 2)), in float64:
    (v1, v2).

    A Hillis-Steele scan of the affine maps (M, u[n]) (``_affine_combine``,
    as ops/iir.py:46-58) inside each chunk of ``chunk`` samples, then across
    the chunks' last states, then each sample's prefix applied to the state
    entering its chunk. M does not vary along time, so the maps' matrix
    parts are M's powers, the same for every sample: at span d each state
    adds M^d times the one d samples before.
    """
    m = m.double()
    bs, t = u1.shape
    n_chunks = -(-t // chunk)
    u = torch.stack([u1.double(), u2.double()], dim=-1)  # (B, T, 2)
    u = F.pad(u, (0, 0, 0, n_chunks * chunk - t)).reshape(bs, n_chunks, chunk, 2)

    def scan(v, p, n):  # inclusive scan along axis 1 of v (B, n, ..., 2)
        d = 1
        while d < n:
            prev = F.pad(v[:, :-d], (0, 0) * (v.ndim - 2) + (d, 0))
            v = v + torch.einsum("bij,b...j->b...i", p, prev)
            p = p @ p
            d *= 2
        return v

    u = scan(u.transpose(1, 2), m, chunk).transpose(1, 2)  # within the chunks
    ends = scan(u[:, :, -1], torch.linalg.matrix_power(m, chunk), n_chunks)  # ... across them
    carry = F.pad(ends[:, :-1], (0, 0, 1, 0))  # the state entering each chunk
    powers = [m]  # M^(j+1) for j < chunk, by doubling
    while len(powers) < chunk:
        top = torch.linalg.matrix_power(m, len(powers))
        powers += [top @ q for q in powers]
    powers = torch.stack(powers[:chunk], dim=1)  # (B, chunk, 2, 2)
    v = u + torch.einsum("bjik,bck->bcji", powers, carry)
    v = v.reshape(bs, n_chunks * chunk, 2)[:, :t]
    return v[..., 0], v[..., 1]


def biquad_scan(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One biquad (TDF-II), causal, zero initial state.

    Args:
      x: (B, T) signals.
      b, a: (B, 3) normalized coefficients (a[:, 0] == 1; it is not read).

    Returns:
      Filtered (B, T), in x's dtype.
    """
    b64, a64, x64 = b.double(), a.double(), x.double()
    a1, a2, b0 = a64[:, 1:2], a64[:, 2:3], b64[:, 0:1]
    m = torch.stack([torch.cat([-a1, torch.ones_like(a1)], -1), torch.cat([-a2, torch.zeros_like(a2)], -1)], 1)
    s1, _ = lti2_scan(m, (b64[:, 1:2] - a1 * b0) * x64, (b64[:, 2:3] - a2 * b0) * x64)
    return (b0 * x64 + F.pad(s1[:, :-1], (1, 0))).to(x.dtype)


def sosfilt_scan(x: torch.Tensor, sos_b: torch.Tensor, sos_a: torch.Tensor) -> torch.Tensor:
    """Cascade of second-order sections, causal, zero initial state.

    Args:
      x: (B, T).
      sos_b, sos_a: (B, S, 3) per-section normalized coefficients.

    Returns:
      Filtered (B, T), ``scipy.signal.sosfilt``'s result, each section
      rounded to x's dtype.
    """
    y = x
    for s in range(sos_b.shape[1]):
        y = biquad_scan(y, sos_b[:, s], sos_a[:, s])
    return y
