"""Hann window and STFT with the torch.stft conventions of the reference.

Port of ``diffmst_tpu/ops/stft.py``: centre reflect padding by n_fft // 2,
a periodic Hann window, onesided output laid out (..., freq_bins, frames).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["hann_window", "stft"]


@functools.lru_cache(maxsize=32)
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window matching torch.hann_window(n). Read-only."""
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)
    w.flags.writeable = False
    return w


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    center: bool = True,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., T) -> complex (..., n_fft // 2 + 1, frames); 1 + T // hop frames
    with ``center``."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = torch.from_numpy(hann_window(win_length).copy()).to(x.device, x.dtype)
    lead = x.shape[:-1]
    X = torch.stft(
        x.reshape(-1, x.shape[-1]),
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
