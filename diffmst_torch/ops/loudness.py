"""ITU-R BS.1770-4 integrated loudness.

Port of ``diffmst_tpu/ops/loudness.py``:
  * ``integrated_loudness`` and ``loudness_normalize`` — host NumPy/SciPy
    (a sequential IIR by ``scipy.signal.sosfilt``); inference gates and
    normalizes tracks with it before anything reaches the device;
  * ``integrated_loudness_torch`` — the counterpart of
    ``integrated_loudness_jax``: (batch, channels, time) tensors on any
    device, the K-weighting by frequency sampling (a circular FFT), the
    BS.1770-4 gates by masked means.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import signal as _sps

__all__ = ["k_weighting_sos", "integrated_loudness", "loudness_normalize", "integrated_loudness_torch"]


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


def loudness_normalize(data: np.ndarray, sample_rate: float, target_lufs_db: float) -> np.ndarray:
    """Host audio scaled to ``target_lufs_db`` integrated loudness; silence
    (-inf LUFS) comes back unchanged."""
    lufs = integrated_loudness(data, sample_rate)
    if not np.isfinite(lufs):
        return data
    return data * (10.0 ** ((target_lufs_db - lufs) / 20.0))


def integrated_loudness_torch(x: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Integrated loudness (LUFS, shape (batch,)) of (batch, channels, time)
    audio on its device, in its dtype.

    The K-weighting is applied by frequency sampling: the product of the two
    sections' responses, each the ratio of the rfft'd numerator and
    denominator at the signal's length, multiplies the signal's rfft, and
    ``irfft`` returns it (a circular filter: within a small boundary error
    of the IIR for multi-second signals). The mean squares of 400 ms blocks
    at a 100 ms step come from a cumulative sum; a signal shorter than one
    block is one block. The absolute (-70 LUFS) and relative (-10 LU) gates
    are masked means, so the shapes do not depend on the data.
    """
    bs, chs, t = x.shape
    # JAX's float32 coefficients, its response in x's dtype: JAX keeps the
    # response complex64 in a float64 run (diffmst_tpu/ops/loudness.py:152-
    # 156), 3e-3 off in its worst bin (ROADMAP Queue 3)
    sos = torch.as_tensor(np.asarray(k_weighting_sos(sample_rate), np.float32)).to(x.device)
    b, a = sos[:, :3].to(x.dtype), sos[:, 3:].to(x.dtype)
    h = torch.prod(torch.fft.rfft(b, n=t, dim=-1) / torch.fft.rfft(a, n=t, dim=-1), dim=0)
    w = torch.fft.irfft(torch.fft.rfft(x, n=t, dim=-1) * h, n=t, dim=-1)

    block = int(round(0.4 * sample_rate))
    step = block // 4
    sq = torch.square(w)
    if t < block:
        z = torch.mean(sq, dim=-1, keepdim=True).transpose(1, 2)  # (bs, 1, chs)
    else:
        num_blocks = (t - block) // step + 1
        csum = torch.cat([sq.new_zeros(bs, chs, 1), torch.cumsum(sq, dim=-1)], dim=-1)
        starts = step * torch.arange(num_blocks, device=x.device)
        z = ((csum[:, :, starts + block] - csum[:, :, starts]) / block).transpose(1, 2)

    g = torch.as_tensor(_CHANNEL_G[:chs], dtype=x.dtype, device=x.device)

    def lufs(power: torch.Tensor) -> torch.Tensor:
        return -0.691 + 10.0 * torch.log10(torch.clamp(power, min=1e-12))

    def gated_mean(mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        return (z * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)  # (bs, chs)

    above_abs = lufs((z * g).sum(-1)) > _ABS_GATE
    gamma_r = lufs((gated_mean(above_abs) * g).sum(-1)) - 10.0
    gated = above_abs & (lufs((z * g).sum(-1)) > gamma_r[:, None])
    return lufs((gated_mean(gated) * g).sum(-1))
