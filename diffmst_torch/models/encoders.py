"""Waveform encoders producing per-signal embeddings.

Port of ``diffmst_tpu/models/encoders.py``:

* ``SpectrogramEncoder``: STFT -> (|X| + eps)^0.3 -> [BatchNorm] -> Cnn14
  -> embedding. ``input_batchnorm`` (default False) normalizes the
  compressed magnitudes over the input-channel axis, as the Flax model's
  ``nn.BatchNorm(axis=1, momentum=0.9, epsilon=1e-5)`` named ``bn``, always
  in float32; ``encoder_batchnorm`` (default True) is Cnn14's
  ``use_batchnorm``. The JAX package's compute options: ``cnn_min_width``
  (Cnn14's width floor), ``crop_nyquist`` (drop bin ``n_fft // 2`` before
  the magnitude: 1,024 bins, Cnn14's pooled shapes unchanged), ``dtype``
  (Cnn14's compute dtype) and ``remat_blocks`` (Cnn14's first blocks
  recomputed in the backward pass). ``remat`` recomputes the whole encoder
  there instead (``MixStyleTransferModel.build(remat_encoders=True)``, JAX's
  ``nn.remat(SpectrogramEncoder)``). ``bn_axis_name`` names the mesh axes
  over which Cnn14's train-mode BatchNorm, and the input BatchNorm, take
  their statistics (``cnn14.batch_norm``; JAX's ``encoders.py:34, :73``
  threads it to Cnn14 alone, whose input BatchNorm then reduces over a
  shard's tracks only: the port's matches the single-device step).
* ``WaveformTransformerEncoder`` and ``PositionalEncoding``: the
  alternative block-transformer encoder (``encoders.py:82-127``). The
  encoder prepends a learned CLS block to the waveform's non-overlapping
  blocks, runs a post-norm transformer with ``d_model = block_size`` and
  returns the CLS row; like JAX's, it adds no positional encoding.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from diffmst_torch.models.cnn14 import Cnn14, batch_norm, rematerialized
from diffmst_torch.models.transformer import TransformerEncoder
from diffmst_torch.ops.stft import stft

__all__ = ["SpectrogramEncoder", "WaveformTransformerEncoder", "PositionalEncoding"]


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
        cnn_min_width: int = 0,
        crop_nyquist: bool = False,
        dtype: Optional[torch.dtype] = None,
        remat_blocks: int = 0,
        remat: bool = False,
        bn_axis_name=None,
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.spec_power = spec_power
        self.spec_eps = spec_eps
        self.crop_nyquist = crop_nyquist
        self.remat = remat
        self.bn_axis_name = bn_axis_name
        if input_batchnorm:
            # Flax momentum 0.9 is torch's 0.1; the update itself is
            # cnn14.batch_norm's, the variance biased as in Flax
            self.bn = nn.BatchNorm2d(n_inputs, eps=1e-5, momentum=0.1)
        self.input_batchnorm = input_batchnorm
        self.model = Cnn14(
            embed_dim, n_inputs=n_inputs, base_width=cnn_base_width, use_batchnorm=encoder_batchnorm,
            dtype=dtype, min_width=cnn_min_width, remat_blocks=remat_blocks, bn_axis_name=bn_axis_name,
        )

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(bs, chs, seq_len) waveform -> (bs, embed_dim); ``train`` selects
        the BatchNorm mode."""
        if self.remat:
            return rematerialized(self._encode, x, train)
        return self._encode(x, train)

    def _encode(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        bs, chs, seq_len = x.shape
        X = stft(x.reshape(bs * chs, seq_len), self.n_fft, self.hop_length)
        if self.crop_nyquist:
            X = X[..., : self.n_fft // 2, :]
        mag = torch.pow(X.abs() + self.spec_eps, self.spec_power)
        mag = mag.reshape(bs, chs, *mag.shape[-2:])
        if self.input_batchnorm:
            mag = batch_norm(self.bn, mag, train, self.bn_axis_name)
        return self.model(mag, train)


class PositionalEncoding(nn.Module):
    """Sinusoidal positions added to (bs, seq, d_model), then, in training,
    dropout (Flax's ``nn.Dropout``: kept values scaled by 1 / (1 - p)) drawn
    from the ``generator`` the caller passes."""

    def __init__(self, d_model: int, max_len: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.dropout = dropout

    def table(self, n: int, device=None) -> torch.Tensor:
        """The first ``n`` rows of the (max_len, d_model) float32 table."""
        pos = torch.arange(self.max_len, dtype=torch.float32, device=device)[:n, None]
        div = torch.exp(torch.arange(0, self.d_model, 2, dtype=torch.float32, device=device)
                        * (-math.log(10000.0) / self.d_model))
        pe = torch.zeros(n, self.d_model, device=device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return pe

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.table(x.shape[1], x.device)[None]
        if train and self.dropout > 0:
            if generator is None:
                raise ValueError("PositionalEncoding's dropout draws from an explicit generator")
            keep_prob = 1.0 - self.dropout
            u = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device)
            x = torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))
        return x


class WaveformTransformerEncoder(nn.Module):
    """(bs, chs, seq_len) -> (bs, block_size): the CLS row of a transformer
    over [CLS, the chs * (seq_len // block_size) waveform blocks]."""

    def __init__(self, n_inputs: int = 1, block_size: int = 1024, embed_dim: int = 512,
                 nhead: int = 8, num_layers: int = 12):
        super().__init__()
        self.block_size = block_size
        self.cls = nn.Parameter(torch.empty(1, 1, block_size))
        self.model = TransformerEncoder(block_size, nhead, num_layers)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bs, chs, seq_len = x.shape
        n_blocks = seq_len // self.block_size
        x = x[..., : n_blocks * self.block_size].reshape(bs, chs * n_blocks, self.block_size)
        z = self.model(torch.cat([self.cls.expand(bs, 1, self.block_size), x], dim=1))
        return z[:, 0, :]
