"""Hann window, STFT and inverse STFT with the torch.stft conventions of the
reference.

Port of ``diffmst_tpu/ops/stft.py``: centre reflect padding by n_fft // 2,
a periodic Hann window, onesided output laid out (..., freq_bins, frames).
The padding is NumPy's reflection (``reflect_pad``), which, unlike
``torch.stft``'s, takes a signal of any length: a pad as long as the signal
or longer reflects again and again.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hann_window", "reflect_pad", "stft", "istft"]


@functools.lru_cache(maxsize=32)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window matching torch.hann_window(n). Read-only."""
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)
    w.flags.writeable = False
    return w


def _window(n: int, like: torch.Tensor) -> torch.Tensor:
    """``hann_window(n)`` as ``like``'s real dtype on its device, computed
    there as NumPy computes it (float64, rounded to float32; bitwise on the
    CPU): a step captured into a CUDA graph may copy nothing from the host."""
    k = torch.arange(n, dtype=torch.float64, device=like.device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).float().to(like.real.dtype)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """(..., T) -> (..., left + T + right), as ``np.pad(x, ..., mode="reflect")``
    (and ``jnp.pad``) pad the last axis, for any pad widths.

    Pads shorter than the signal take ``F.pad``'s reflection. Longer ones
    gather from the signal's periodic reflection, period 2 (T - 1), which is
    what NumPy's repeated reflection gives; a one-sample signal repeats its
    sample, as NumPy's does.
    """
    t = x.shape[-1]
    if left < t and right < t:
        lead = x.shape[:-1]
        return F.pad(x.reshape(1, -1, t), (left, right), mode="reflect").reshape(*lead, left + t + right)
    # the index is made on x's device: no copy from the host
    pos = torch.arange(-left, t + right, device=x.device)
    if t == 1:
        idx = torch.zeros_like(pos)
    else:
        m = torch.remainder(pos, 2 * (t - 1))
        idx = torch.where(m < t, m, 2 * (t - 1) - m)
    return x.index_select(-1, idx)


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., T) -> complex (..., n_fft // 2 + 1, frames); 1 + T // hop frames
    with ``center``, for any T."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = _window(win_length, x)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if center and n_fft // 2 >= x.shape[-1]:
        # torch.stft's reflection needs a pad shorter than the signal
        x = reflect_pad(x, n_fft // 2, n_fft // 2)
        center = False
    X = torch.stft(
        x,
        n_fft,
        hop_length,
        win_length=win_length,
        window=window,
        center=center,
        pad_mode="reflect",
        onesided=True,
        return_complex=True,
    )
    return X.reshape(*lead, *X.shape[-2:])


def _ola(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (B, frame_len, F) frames at stride ``hop`` -> (B, (F - 1)
    * hop + frame_len)."""
    frame_len, num_frames = frames.shape[-2:]
    total = (num_frames - 1) * hop + frame_len
    out = F.fold(frames, output_size=(1, total), kernel_size=(1, frame_len), stride=(1, hop))
    return out.reshape(frames.shape[0], total)


def istft(
    X: torch.Tensor,
    n_fft: int,
    hop_length: int,
    length: int,
    center: bool = True,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse STFT of (..., n_fft // 2 + 1, frames) -> (..., length).

    JAX's ``istft``: the windowed overlap-add divided by the overlap-added
    squared window, floored at 1e-11 (where ``torch.istft`` refuses a window
    envelope below that), then the centre trim and ``[:length]``.
    """
    if window is None:
        window = _window(n_fft, X)
    lead, num_frames = X.shape[:-2], X.shape[-1]
    X = X.reshape(-1, *X.shape[-2:])
    # pocketfft (the CPU's irfft, and XLA's) ignores the imaginary parts of
    # the DC and Nyquist bins; cuFFT's C2R transform does not, so they are
    # dropped first: HDemucs's masked spectrum is not Hermitian there
    X = torch.cat([X[:, :1].real.to(X.dtype), X[:, 1:-1], X[:, -1:].real.to(X.dtype)], dim=1)
    frames = torch.fft.irfft(X, n=n_fft, dim=-2) * window[:, None]
    y = _ola(frames, hop_length)
    wsq = _ola((window**2)[None, :, None].expand(1, n_fft, num_frames), hop_length)
    y = y / torch.clamp(wsq, min=1e-11)
    if center:
        y = y[..., n_fft // 2:]
    y = y[..., :length]
    return y.reshape(*lead, y.shape[-1])
