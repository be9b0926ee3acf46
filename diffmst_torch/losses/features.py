"""Audio-feature loss (AFLoss) and its differentiable feature transforms.

Port of ``diffmst_tpu/losses/features.py``: a weighted MSE over five
features of the predicted and the target stereo mix (RMS, crest factor,
stereo width, stereo imbalance, and a 24-band Bark spectrum from a
32,768-point STFT, mid-side by default), returned as a dict of named
weighted losses, which the train step sums. The shipped weights are
[0.1, 0.001, 1.0, 1.0, 0.1] (``configs/models/naive+feat.yaml``).

Gradients follow JAX's: the maxima and the ``maximum(., floor)`` guards
split a tie evenly (``torch.amax``, ``torch.maximum``), and |X| of a zero
STFT bin (the side channel of a mix with L == R) has gradient 0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from diffmst_torch.losses.filterbank import barkscale_fbanks
from diffmst_torch.ops.stft import stft

__all__ = [
    "compute_rms",
    "compute_crest_factor",
    "compute_stereo_width",
    "compute_stereo_imbalance",
    "compute_barkspectrum",
    "compute_melspectrum",
    "AudioFeatureLoss",
]


def _floor(x: torch.Tensor, value: float) -> torch.Tensor:
    """jnp.maximum(x, value): the gradient is halved where x == value."""
    return torch.maximum(x, x.new_tensor(value))


def compute_rms(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """Root-mean-square energy per channel: (bs, chs, T) -> (bs, chs)."""
    return torch.sqrt(_floor(torch.mean(torch.square(x), dim=-1), 1e-8))


def compute_crest_factor(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """Peak-to-RMS ratio in dB: (bs, chs, T) -> (bs, chs)."""
    num = torch.amax(torch.abs(x), dim=-1)
    den = _floor(compute_rms(x), 1e-8)
    return 20.0 * torch.log10(_floor(num / den, 1e-8))


def compute_stereo_width(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """Sum/difference energy ratio: (bs, 2, T) -> (bs,)."""
    x_sum = x[:, 0, :] + x[:, 1, :]
    x_diff = x[:, 0, :] - x[:, 1, :]
    sum_energy = torch.mean(torch.square(x_sum), dim=-1)
    diff_energy = torch.mean(torch.square(x_diff), dim=-1)
    return diff_energy / _floor(sum_energy, 1e-8)


def compute_stereo_imbalance(x: torch.Tensor, **kwargs) -> torch.Tensor:
    """L/R energy imbalance: (bs, 2, T) -> (bs,)."""
    left = torch.mean(torch.square(x[:, 0, :]), dim=-1)
    right = torch.mean(torch.square(x[:, 1, :]), dim=-1)
    return (right - left) / _floor(right + left, 1e-8)


@functools.lru_cache(maxsize=16)
def _bark_matrix(fft_size: int, f_min: float, f_max: float, n_bands: int, sample_rate: int,
                 device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (n_bands, fft_size // 2 + 1) float32 filterbank, as ``dtype`` on
    ``device``, uploaded once."""
    fb = barkscale_fbanks(fft_size // 2 + 1, f_min, f_max, n_bands, sample_rate)
    return torch.from_numpy(np.ascontiguousarray(fb.T)).to(device, dtype)


def compute_barkspectrum(
    x: torch.Tensor,
    fft_size: int = 32768,
    n_bands: int = 24,
    sample_rate: int = 44100,
    f_min: float = 20.0,
    f_max: float = 20000.0,
    mode: str = "mid-side",
    **kwargs,
) -> torch.Tensor:
    """Log Bark-band spectrum: (bs, 2, T) -> (bs, n_bands, n_signals).

    mode: "mono" (the channels' mean), "stereo" (L, R) or "mid-side"
    (L + R, L - R; the reference's default). Each signal's |STFT| (hop
    ``fft_size // 4``) is averaged over time, then summed into the bands.
    """
    fb = _bark_matrix(fft_size, f_min, f_max, n_bands, int(sample_rate), x.device, x.dtype)
    if mode == "mono":
        signals = [torch.mean(x, dim=1)]
    elif mode == "stereo":
        signals = [x[:, 0, :], x[:, 1, :]]
    elif mode == "mid-side":
        signals = [x[:, 0, :] + x[:, 1, :], x[:, 0, :] - x[:, 1, :]]
    else:
        raise ValueError(f"invalid mode {mode}")
    outs = []
    for s in signals:
        X = torch.abs(stft(s, fft_size, fft_size // 4)).mean(dim=-1, keepdim=True)  # (bs, bins, 1)
        outs.append(torch.log(torch.matmul(fb, X) + 1e-8))  # (bs, n_bands, 1)
    return torch.cat(outs, dim=-1)


@functools.lru_cache(maxsize=4)
def _mel_fb(sr: int, nfft: int, nb: int) -> np.ndarray:
    """(nb, nfft // 2 + 1) float32 triangular mel filterbank (HTK mel scale)."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), nb + 2)
    f_pts = mel_to_hz(m_pts)
    all_freqs = np.linspace(0, sr / 2, nfft // 2 + 1)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0, np.minimum(down, up)).astype(np.float32).T
    fb.flags.writeable = False
    return fb


def compute_melspectrum(
    x: torch.Tensor,
    sample_rate: int = 44100,
    fft_size: int = 32768,
    n_bins: int = 128,
    **kwargs,
) -> torch.Tensor:
    """Log mel spectrum of the mono mix's first ``fft_size`` samples:
    (bs, 2, T) -> (bs, n_bins, 1). Not among the loss's five features, as
    in the reference."""
    fb = torch.from_numpy(_mel_fb(int(sample_rate), fft_size, n_bins).copy()).to(x.device, x.dtype)
    xm = torch.mean(x, dim=1)
    X = torch.abs(torch.fft.rfft(xm, n=fft_size, dim=-1))[:, :, None]
    return torch.log(torch.matmul(fb, X) + 1e-8)


_TRANSFORMS = {
    "rms": compute_rms,
    "crest_factor": compute_crest_factor,
    "stereo_width": compute_stereo_width,
    "stereo_imbalance": compute_stereo_imbalance,
    "barkspectrum": compute_barkspectrum,
}


@dataclasses.dataclass(frozen=True)
class AudioFeatureLoss:
    """Weighted MSE over the five mix features; returns a named-loss dict."""

    weights: Sequence[float] = (0.1, 0.001, 1.0, 1.0, 0.1)
    sample_rate: int = 44100
    stem_separation: bool = False  # accepted for config parity (unused, as in the reference)
    use_clap: bool = False  # a stale reference option; must stay False
    barkspectrum_fft_size: int = 32768

    def __post_init__(self):
        if len(self.weights) != len(_TRANSFORMS):
            raise ValueError(f"expected {len(_TRANSFORMS)} weights, got {len(self.weights)}")
        if self.use_clap:
            raise NotImplementedError(
                "CLAP loss was removed from the reference (StereoCLAPLoss is "
                "undefined there); not supported."
            )

    def __call__(self, pred: torch.Tensor, target: torch.Tensor):
        """(bs, 2, T) pred and target -> {"mix-rms": ..., ...}, weighted scalars."""
        losses = {}
        for (name, fn), w in zip(_TRANSFORMS.items(), self.weights):
            kwargs = {"sample_rate": self.sample_rate}
            if name == "barkspectrum":
                kwargs["fft_size"] = self.barkspectrum_fft_size
            p = fn(pred, **kwargs)
            t = fn(target, **kwargs)
            losses[f"mix-{name}"] = w * torch.mean(torch.square(p - t))
        return losses
