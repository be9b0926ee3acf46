"""Bark-scale triangular filterbank, a host-side NumPy constant.

Port of ``diffmst_tpu/losses/filterbank.py`` (the reference's adaptation of
torchaudio's prototype, Traunmuller scale by default): the same NumPy
arithmetic, so the (n_freqs, n_barks) matrix is bitwise the JAX package's.

Behavioral quirks of the reference preserved deliberately (they shape the
loss the published models trained with): the Bark->Hz correction applies the
"<2 Bark" branch *or* the ">20.1 Bark" branch, never both (filter.py:89-94
uses if/elif on `any`), so the top band edges extend past Nyquist and the
highest filters may be all-zero.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["barkscale_fbanks", "hz_to_bark", "bark_to_hz"]


def hz_to_bark(freq: float, bark_scale: str = "traunmuller") -> float:
    if bark_scale == "wang":
        return 6.0 * math.asinh(freq / 600.0)
    if bark_scale == "schroeder":
        return 7.0 * math.asinh(freq / 650.0)
    if bark_scale != "traunmuller":
        raise ValueError("bark_scale must be traunmuller, schroeder, or wang")
    barks = ((26.81 * freq) / (1960.0 + freq)) - 0.53
    if barks < 2:
        barks += 0.15 * (2 - barks)
    elif barks > 20.1:
        barks += 0.22 * (barks - 20.1)
    return barks


def bark_to_hz(barks: np.ndarray, bark_scale: str = "traunmuller") -> np.ndarray:
    barks = np.asarray(barks, dtype=np.float64).copy()
    if bark_scale == "wang":
        return 600.0 * np.sinh(barks / 6.0)
    if bark_scale == "schroeder":
        return 650.0 * np.sinh(barks / 7.0)
    if bark_scale != "traunmuller":
        raise ValueError("bark_scale must be traunmuller, schroeder, or wang")
    # Reference applies only ONE correction branch (if/elif over `any`).
    if np.any(barks < 2):
        idx = barks < 2
        barks[idx] = (barks[idx] - 0.3) / 0.85
    elif np.any(barks > 20.1):
        idx = barks > 20.1
        barks[idx] = (barks[idx] + 4.422) / 1.22
    return 1960.0 * ((barks + 0.53) / (26.28 - barks))


def _triangular_filterbank(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_filter + 2)
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


@functools.lru_cache(maxsize=8)
def barkscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_barks: int,
    sample_rate: int,
    bark_scale: str = "traunmuller",
) -> np.ndarray:
    """Triangular Bark filterbank, shape (n_freqs, n_barks), float32. Read-only."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_bark(f_min, bark_scale)
    m_max = hz_to_bark(f_max, bark_scale)
    m_pts = np.linspace(m_min, m_max, n_barks + 2)
    f_pts = bark_to_hz(m_pts, bark_scale)
    fb = _triangular_filterbank(all_freqs, f_pts).astype(np.float32)
    fb.flags.writeable = False  # one cached array serves every caller
    return fb
