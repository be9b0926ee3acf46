"""ITU-R BS.1770-4 integrated loudness on the host (NumPy/SciPy).

The port's own copy of ``diffmst_tpu/ops/loudness.py``'s host path
(``k_weighting_sos``, ``_block_power``, ``integrated_loudness``): inference
gates and normalizes tracks with it before anything reaches the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy import signal as _sps

__all__ = ["k_weighting_sos", "integrated_loudness"]


@functools.lru_cache(maxsize=8)
def k_weighting_sos(sample_rate: float) -> np.ndarray:
    """K-weighting prefilter as two biquads, scipy sos layout (2, 6).

    Stage 1: +4 dB RBJ high shelf, fc 1500 Hz, Q 1/sqrt(2).
    Stage 2: RBJ high-pass, fc 38 Hz, Q 0.5.
    """
    fs = float(sample_rate)

    G, q, fc = 4.0, 1.0 / math.sqrt(2.0), 1500.0
    A = 10.0 ** (G / 40.0)
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b0 = A * ((A + 1) + (A - 1) * cw + 2 * math.sqrt(A) * alpha)
    b1 = -2 * A * ((A - 1) + (A + 1) * cw)
    b2 = A * ((A + 1) + (A - 1) * cw - 2 * math.sqrt(A) * alpha)
    a0 = (A + 1) - (A - 1) * cw + 2 * math.sqrt(A) * alpha
    a1 = 2 * ((A - 1) - (A + 1) * cw)
    a2 = (A + 1) - (A - 1) * cw - 2 * math.sqrt(A) * alpha
    shelf = np.array([b0, b1, b2, a0, a1, a2]) / a0

    q, fc = 0.5, 38.0
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    b0 = (1 + cw) / 2.0
    b1 = -(1 + cw)
    b2 = (1 + cw) / 2.0
    a0 = 1 + alpha
    a1 = -2 * cw
    a2 = 1 - alpha
    hp = np.array([b0, b1, b2, a0, a1, a2]) / a0

    return np.stack([shelf, hp]).astype(np.float64)


# Channel weights: L, R, C, Ls, Rs per BS.1770.
_CHANNEL_G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])
_ABS_GATE = -70.0


def _block_power(data: np.ndarray, sample_rate: float) -> tuple[np.ndarray, np.ndarray]:
    """(z, l): mean-square power (blocks, channels) and block loudness (blocks,)
    for 400 ms blocks at 75 % overlap of K-weighted (samples, channels) audio."""
    block = int(round(0.4 * sample_rate))
    step = int(round(block * 0.25))
    n = data.shape[0]
    if n < block:
        z = np.mean(np.square(data), axis=0, keepdims=True)
    else:
        num_blocks = (n - block) // step + 1
        idx = np.arange(block)[None, :] + step * np.arange(num_blocks)[:, None]
        z = np.square(data)[idx].mean(axis=1)
    g = _CHANNEL_G[: data.shape[1]]
    l = -0.691 + 10.0 * np.log10(np.maximum((g * z).sum(axis=1), 1e-12))
    return z, l


def integrated_loudness(data: np.ndarray, sample_rate: float) -> float:
    """BS.1770-4 integrated loudness (LUFS) of (samples,) or (samples,
    channels) host audio; -inf for silence."""
    if data.ndim == 1:
        data = data[:, None]
    weighted = _sps.sosfilt(k_weighting_sos(sample_rate), data, axis=0)
    z, l = _block_power(weighted, sample_rate)
    above_abs = l > _ABS_GATE
    if not np.any(above_abs):
        return float("-inf")
    g = _CHANNEL_G[: data.shape[1]]
    z_avg = z[above_abs].mean(axis=0)
    gamma_r = -0.691 + 10.0 * np.log10(np.maximum((g * z_avg).sum(), 1e-12)) - 10.0
    gated = above_abs & (l > gamma_r)
    if not np.any(gated):
        return float("-inf")
    z_avg = z[gated].mean(axis=0)
    return float(-0.691 + 10.0 * np.log10(np.maximum((g * z_avg).sum(), 1e-12)))
