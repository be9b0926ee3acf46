"""Spectrogram encoder: STFT -> (|X| + eps)^0.3 -> Cnn14 -> embedding.

Port of ``diffmst_tpu/models/encoders.py::SpectrogramEncoder`` without its
opt-in variants (input BatchNorm, the Nyquist-bin crop, bf16 compute).
"""

from __future__ import annotations

import torch
from torch import nn

from diffmst_torch.models.cnn14 import Cnn14
from diffmst_torch.ops.stft import stft

__all__ = ["SpectrogramEncoder"]


class SpectrogramEncoder(nn.Module):
    def __init__(
        self,
        embed_dim: int = 128,
        n_inputs: int = 1,
        n_fft: int = 2048,
        hop_length: int = 512,
        spec_power: float = 0.3,
        spec_eps: float = 1e-8,
        cnn_base_width: int = 64,
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.spec_power = spec_power
        self.spec_eps = spec_eps
        self.model = Cnn14(embed_dim, n_inputs=n_inputs, base_width=cnn_base_width)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(bs, chs, seq_len) waveform -> (bs, embed_dim); ``train`` selects
        Cnn14's BatchNorm mode."""
        bs, chs, seq_len = x.shape
        X = stft(x.reshape(bs * chs, seq_len), self.n_fft, self.hop_length)
        mag = torch.pow(X.abs() + self.spec_eps, self.spec_power)
        return self.model(mag.reshape(bs, chs, *mag.shape[-2:]), train)
