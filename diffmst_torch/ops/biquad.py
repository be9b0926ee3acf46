"""Biquad coefficients (RBJ Audio-EQ-Cookbook) and cascade frequency response.

Port of ``diffmst_tpu/ops/biquad.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["biquad", "sos_frequency_response", "LOW_SHELF", "HIGH_SHELF", "PEAKING"]

LOW_SHELF = "low_shelf"
HIGH_SHELF = "high_shelf"
PEAKING = "peaking"


def biquad(
    gain_db: torch.Tensor,
    cutoff_freq: torch.Tensor,
    q_factor: torch.Tensor,
    sample_rate: float,
    filter_type: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, a), each (..., 3), normalized so a[..., 0] == 1."""
    A = torch.pow(10.0, gain_db / 40.0)
    w0 = 2.0 * math.pi * (cutoff_freq / sample_rate)
    cos_w0 = torch.cos(w0)
    alpha = torch.sin(w0) / (2.0 * q_factor)
    sqrt_A = torch.sqrt(A)

    if filter_type == PEAKING:
        b0 = 1.0 + alpha * A
        b1 = -2.0 * cos_w0
        b2 = 1.0 - alpha * A
        a0 = 1.0 + alpha / A
        a1 = -2.0 * cos_w0
        a2 = 1.0 - alpha / A
    elif filter_type == LOW_SHELF:
        b0 = A * ((A + 1.0) - (A - 1.0) * cos_w0 + 2.0 * sqrt_A * alpha)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cos_w0)
        b2 = A * ((A + 1.0) - (A - 1.0) * cos_w0 - 2.0 * sqrt_A * alpha)
        a0 = (A + 1.0) + (A - 1.0) * cos_w0 + 2.0 * sqrt_A * alpha
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cos_w0)
        a2 = (A + 1.0) + (A - 1.0) * cos_w0 - 2.0 * sqrt_A * alpha
    elif filter_type == HIGH_SHELF:
        b0 = A * ((A + 1.0) + (A - 1.0) * cos_w0 + 2.0 * sqrt_A * alpha)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cos_w0)
        b2 = A * ((A + 1.0) + (A - 1.0) * cos_w0 - 2.0 * sqrt_A * alpha)
        a0 = (A + 1.0) - (A - 1.0) * cos_w0 + 2.0 * sqrt_A * alpha
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cos_w0)
        a2 = (A + 1.0) - (A - 1.0) * cos_w0 - 2.0 * sqrt_A * alpha
    else:
        raise ValueError(f"unknown filter_type: {filter_type!r}")

    b = torch.stack([b0, b1, b2], dim=-1) / a0[..., None]
    a = torch.stack([a0, a1, a2], dim=-1) / a0[..., None]
    return b, a


def sos_frequency_response(b: torch.Tensor, a: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Complex response prod_s B_s / A_s on the n_fft rFFT grid.

    Each 3-tap polynomial is evaluated directly, multiplied through by
    e^{jw} (the factor cancels in B/A): p1 + (p0 + p2) cos w + j (p0 - p2)
    sin w, with cos w - 1 = -2 sin^2(w/2) so low bins keep their precision
    in float32. The frequency grid takes b's dtype.

    Args:
      b, a: (..., n_sections, 3).

    Returns:
      (..., n_fft // 2 + 1) complex64 (complex128 for float64 b).
    """
    k = torch.arange(n_fft // 2 + 1, dtype=b.dtype, device=b.device)
    half_w = (math.pi / n_fft) * k
    sin_half = torch.sin(half_w)
    cos_m1 = -2.0 * sin_half * sin_half  # cos w - 1
    sin_w = torch.sin(2.0 * half_w)
    H = None
    for s in range(b.shape[-2]):
        b0, b1, b2 = b[..., s, 0:1], b[..., s, 1:2], b[..., s, 2:3]
        a0, a1, a2 = a[..., s, 0:1], a[..., s, 1:2], a[..., s, 2:3]
        num = torch.complex((b0 + b1 + b2) + (b0 + b2) * cos_m1, (b0 - b2) * sin_w)
        den = torch.complex((a0 + a1 + a2) + (a0 + a2) * cos_m1, (a0 - a2) * sin_w)
        H = num / den if H is None else H * (num / den)
    return H
