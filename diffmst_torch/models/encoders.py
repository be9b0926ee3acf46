"""Spectrogram encoder: STFT -> (|X| + eps)^0.3 -> [BatchNorm] -> Cnn14 -> embedding.

Port of ``diffmst_tpu/models/encoders.py::SpectrogramEncoder`` with its
BatchNorm keywords: ``input_batchnorm`` (default False) normalizes the
compressed magnitudes over the input-channel axis, as the Flax model's
``nn.BatchNorm(axis=1, momentum=0.9, epsilon=1e-5)`` named ``bn``;
``encoder_batchnorm`` (default True) is Cnn14's ``use_batchnorm``. The
TPU-era opt-ins (``cnn_min_width``, ``crop_nyquist``, the compute dtype,
``remat_blocks``) are not ported (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import torch
from torch import nn

from diffmst_torch.models.cnn14 import Cnn14, batch_norm
from diffmst_torch.ops.stft import stft

__all__ = ["SpectrogramEncoder"]


class SpectrogramEncoder(nn.Module):
    def __init__(
        self,
        embed_dim: int = 128,
        n_inputs: int = 1,
        n_fft: int = 2048,
        hop_length: int = 512,
        input_batchnorm: bool = False,
        encoder_batchnorm: bool = True,
        spec_power: float = 0.3,
        spec_eps: float = 1e-8,
        cnn_base_width: int = 64,
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.spec_power = spec_power
        self.spec_eps = spec_eps
        if input_batchnorm:
            # Flax momentum 0.9 is torch's 0.1; the update itself is
            # cnn14.batch_norm's, the variance biased as in Flax
            self.bn = nn.BatchNorm2d(n_inputs, eps=1e-5, momentum=0.1)
        self.input_batchnorm = input_batchnorm
        self.model = Cnn14(
            embed_dim, n_inputs=n_inputs, base_width=cnn_base_width, use_batchnorm=encoder_batchnorm
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(bs, chs, seq_len) waveform -> (bs, embed_dim); ``train`` selects
        the BatchNorm mode."""
        bs, chs, seq_len = x.shape
        X = stft(x.reshape(bs * chs, seq_len), self.n_fft, self.hop_length)
        mag = torch.pow(X.abs() + self.spec_eps, self.spec_power)
        mag = mag.reshape(bs, chs, *mag.shape[-2:])
        if self.input_batchnorm:
            mag = batch_norm(self.bn, mag, train)
        return self.model(mag, train)
