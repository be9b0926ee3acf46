"""Noise-shaped artificial reverberation: a 12-band filtered-noise IR.

Port of ``diffmst_tpu/ops/reverb.py``, the fx bus's reverb (the reference
console's ``noise_shaped_reverberation``, 65,536 samples and 1,023 taps).
White noise is split into 12 octave bands by a windowed-sinc FIR bank, each
band is shaped by an exponentially decaying envelope whose rate is its
(scaled) decay parameter and weighted by its gain, the bands are averaged
into a stereo impulse response, and the IR is convolved with the input.
Every convolution is an FFT product (``torch.fft``, cuFFT on the card) at
the same 5-smooth length as JAX's.

Randomness is explicit: the noise is passed in (``noise=``, e.g. the JAX
package's draw in the parity tests) or drawn from a ``torch.Generator`` by
``draw_reverb_noise``'s rule. JAX draws ``jax.random.normal(key, ...)``; the
two give different numbers from one seed.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "octave_band_filterbank",
    "next_fast_len",
    "fft_convolve",
    "reverb_noise_shape",
    "draw_reverb_noise",
    "reverb_noise_seed",
    "reverb_noise_from_seed",
    "noise_shaped_reverberation",
]

NUM_BANDS = 12


@functools.lru_cache(maxsize=8)
def octave_band_filterbank(num_taps: int, sample_rate: float) -> np.ndarray:
    """12-band windowed-sinc FIR filterbank: a lowpass, 10 octave bandpasses
    (centres 31.5 Hz to 16 kHz, edges at +-1/2 octave) and a highpass.

    Returns a read-only (12, num_taps) float32 array (a host constant), the
    JAX package's bitwise.
    """
    centers = [31.5, 63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0]
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    window = np.hanning(num_taps)

    def sinc_lowpass(fc: float) -> np.ndarray:
        wc = 2.0 * fc / sample_rate
        h = wc * np.sinc(wc * n)
        return h * window

    filters = []
    # Band 0: lowpass below the lowest octave's lower edge.
    low_edge = centers[0] / math.sqrt(2.0)
    filters.append(sinc_lowpass(low_edge))
    # Bands 1-10: octave bandpasses (difference of lowpasses).
    for fc in centers:
        f_lo = fc / math.sqrt(2.0)
        f_hi = min(fc * math.sqrt(2.0), sample_rate / 2.0 * 0.999)
        filters.append(sinc_lowpass(f_hi) - sinc_lowpass(f_lo))
    # Band 11: highpass above the highest octave's upper edge (spectral inversion).
    hi_edge = min(centers[-1] * math.sqrt(2.0), sample_rate / 2.0 * 0.999)
    hp = -sinc_lowpass(hi_edge)
    hp[(num_taps - 1) // 2] += 1.0
    filters.append(hp)
    bank = np.stack(filters).astype(np.float32)
    bank.flags.writeable = False
    return bank


@functools.lru_cache(maxsize=8)
def _filterbank_tensor(num_taps: int, sample_rate: float, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """``octave_band_filterbank`` as ``dtype`` on ``device``, uploaded once."""
    return torch.from_numpy(octave_band_filterbank(num_taps, sample_rate).copy()).to(device, dtype)


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n: the FFT length of every
    convolution here, as in the JAX package."""
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()  # the next power of two is an upper bound
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            # the smallest power-of-two multiple of p35 that is >= n
            q = p35 * max(1, 1 << max(0, (n + p35 - 1) // p35 - 1).bit_length())
            while q < n:
                q *= 2
            while q // 2 >= n and q % 2 == 0:
                q //= 2
            if n <= q < best:
                best = q
            p35 *= 3
        p5 *= 5
    return best


def fft_convolve(x: torch.Tensor, h: torch.Tensor, mode: str = "causal") -> torch.Tensor:
    """Linear convolution along the last axis by FFT.

    Args:
      x: (..., T) signal.
      h: (..., K) kernel, broadcastable against x's leading dims.
      mode: "causal" returns the first T samples of the full convolution
        (y[n] = sum_m h[m] x[n-m]); "full" returns T+K-1; "valid" returns
        the T-K+1 fully overlapped samples from lag K-1 on.
    """
    t, k = x.shape[-1], h.shape[-1]
    n_min = t + k - 1
    n = next_fast_len(n_min)
    X = torch.fft.rfft(x, n=n, dim=-1)
    H = torch.fft.rfft(h, n=n, dim=-1)
    y = torch.fft.irfft(X * H, n=n, dim=-1)[..., :n_min]
    if mode == "full":
        return y
    if mode == "causal":
        return y[..., :t]
    if mode == "valid":
        return y[..., k - 1 : t]
    raise ValueError(f"unknown mode: {mode!r}")


def reverb_noise_shape(bs: int, chs: int, num_samples: int, num_bandpass_taps: int) -> tuple:
    """The noise one reverb call takes: (bs, chs, 12, num_samples + taps - 1),
    JAX's draw (``ops/reverb.py``: ``jax.random.normal(key, ...)``)."""
    return (bs, chs, NUM_BANDS, num_samples + num_bandpass_taps - 1)


def draw_reverb_noise(generator: torch.Generator, shape: tuple, device: torch.device,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal noise of ``shape`` on ``device``.

    The rule: one 63-bit draw from ``generator`` seeds a generator on
    ``device``, which draws the noise there, so a CPU generator drives a
    draw on the card without a host-side draw or copy. The same generator
    state gives the same noise on the same device.
    """
    return reverb_noise_from_seed(reverb_noise_seed(generator), shape, device, dtype)


def reverb_noise_seed(generator: torch.Generator) -> int:
    """The 63-bit draw from ``generator`` that seeds one reverb noise."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator, device=generator.device))


def reverb_noise_from_seed(seed: int, shape: tuple, device: torch.device,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The noise ``draw_reverb_noise`` gives for the draw ``seed``."""
    child = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=child, device=device, dtype=dtype)


def noise_shaped_reverberation(
    x: torch.Tensor,
    sample_rate: float,
    band0_gain: torch.Tensor,
    band1_gain: torch.Tensor,
    band2_gain: torch.Tensor,
    band3_gain: torch.Tensor,
    band4_gain: torch.Tensor,
    band5_gain: torch.Tensor,
    band6_gain: torch.Tensor,
    band7_gain: torch.Tensor,
    band8_gain: torch.Tensor,
    band9_gain: torch.Tensor,
    band10_gain: torch.Tensor,
    band11_gain: torch.Tensor,
    band0_decay: torch.Tensor,
    band1_decay: torch.Tensor,
    band2_decay: torch.Tensor,
    band3_decay: torch.Tensor,
    band4_decay: torch.Tensor,
    band5_decay: torch.Tensor,
    band6_decay: torch.Tensor,
    band7_decay: torch.Tensor,
    band8_decay: torch.Tensor,
    band9_decay: torch.Tensor,
    band10_decay: torch.Tensor,
    band11_decay: torch.Tensor,
    mix: torch.Tensor,
    num_samples: int = 65536,
    num_bandpass_taps: int = 1023,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stereo noise-shaped reverberation.

    Args:
      x: (batch, 2, time) stereo bus.
      band*_gain, band*_decay: (batch,) parameters in [0, 1].
      mix: (batch,) wet/dry mix in [0, 1] (the console forces 1).
      noise: (batch, 2, 12, num_samples + num_bandpass_taps - 1) standard
        normal noise for the IR; when None it is drawn from ``generator``
        (``draw_reverb_noise``), or, with neither, from a generator seeded 0
        (JAX's default key 0).

    Returns:
      (batch, 2, time) reverberated bus.
    """
    bs, chs, _ = x.shape
    gains = torch.stack(
        [band0_gain, band1_gain, band2_gain, band3_gain, band4_gain, band5_gain,
         band6_gain, band7_gain, band8_gain, band9_gain, band10_gain, band11_gain],
        dim=-1,
    )  # (bs, 12)
    decays = torch.stack(
        [band0_decay, band1_decay, band2_decay, band3_decay, band4_decay, band5_decay,
         band6_decay, band7_decay, band8_decay, band9_decay, band10_decay, band11_decay],
        dim=-1,
    )  # (bs, 12)
    shape = reverb_noise_shape(bs, chs, num_samples, num_bandpass_taps)
    if noise is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = draw_reverb_noise(generator, shape, x.device, x.dtype)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"reverb noise of shape {tuple(noise.shape)}, expected {shape}")
    noise = noise.to(x.device, x.dtype)

    # Each band's noise through a 'valid' convolution, so every IR sample
    # sees a fully formed bandpass response.
    filters = _filterbank_tensor(num_bandpass_taps, float(sample_rate), x.device, x.dtype)
    band_noise = fft_convolve(noise, filters[None, None], mode="valid")  # (bs, chs, 12, T_ir)

    # Exponential band envelopes: decay in [0, 1] -> rate in [1, 11] over the IR.
    t = torch.linspace(0.0, 1.0, num_samples, dtype=x.dtype, device=x.device)
    rate = decays * 10.0 + 1.0  # (bs, 12)
    env = torch.exp(-rate[..., None] * t)  # (bs, 12, T_ir)
    shaped = band_noise * (env * gains[..., None])[:, None, :, :]
    ir = torch.mean(shaped, dim=2)  # (bs, chs, T_ir)

    wet = fft_convolve(x, ir, mode="causal")
    m = mix.reshape(bs, 1, 1)
    return ((1.0 - m) * x + m * wet).to(x.dtype)
