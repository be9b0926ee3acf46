"""Multi-resolution STFT loss (auraloss semantics).

Port of ``diffmst_tpu/losses/mrstft.py``, the loss Method 1 trains with
(``configs/models/naive.yaml``: FFT sizes 512, 2048, 8192, hops 256, 1024,
4096, w_sc 0). Per resolution: spectral convergence, log-magnitude L1 and
linear-magnitude L1, weighted and summed; the resolutions are averaged.
Channels fold into the batch. Magnitudes are sqrt(clamp(|X|^2, eps)), as
auraloss takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from diffmst_torch.ops.stft import stft

__all__ = ["MultiResolutionSTFTLoss", "stft_loss"]


def _mag(x: torch.Tensor, n_fft: int, hop: int, win: int, eps: float) -> torch.Tensor:
    X = stft(x, n_fft, hop, win_length=win)
    return torch.sqrt(torch.clamp(X.real**2 + X.imag**2, min=eps))


def stft_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    n_fft: int,
    hop: int,
    win: int,
    w_sc: float = 0.0,
    w_log_mag: float = 1.0,
    w_lin_mag: float = 1.0,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Single-resolution STFT loss over (..., T) signals (channels folded)."""
    pm = _mag(pred, n_fft, hop, win, eps)
    tm = _mag(target, n_fft, hop, win, eps)
    loss = pred.new_zeros(())
    if w_sc:
        loss = loss + w_sc * (torch.linalg.norm((tm - pm).reshape(-1))
                              / (torch.linalg.norm(tm.reshape(-1)) + eps))
    if w_log_mag:
        loss = loss + w_log_mag * torch.mean(torch.abs(torch.log(tm) - torch.log(pm)))
    if w_lin_mag:
        loss = loss + w_lin_mag * torch.mean(torch.abs(tm - pm))
    return loss


@dataclasses.dataclass(frozen=True)
class MultiResolutionSTFTLoss:
    fft_sizes: Sequence[int] = (512, 2048, 8192)
    hop_sizes: Sequence[int] = (256, 1024, 4096)
    win_lengths: Sequence[int] = (512, 2048, 8192)
    w_sc: float = 0.0
    w_log_mag: float = 1.0
    w_lin_mag: float = 1.0

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Loss over (bs, chs, T) mixes, channels folded into the batch."""
        if pred.ndim == 3:
            pred = pred.reshape(-1, pred.shape[-1])
            target = target.reshape(-1, target.shape[-1])
        total = pred.new_zeros(())
        for n_fft, hop, win in zip(self.fft_sizes, self.hop_sizes, self.win_lengths):
            total = total + stft_loss(
                pred, target, n_fft, hop, win, self.w_sc, self.w_log_mag, self.w_lin_mag
            )
        return total / len(self.fft_sizes)
