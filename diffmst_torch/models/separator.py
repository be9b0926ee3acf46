"""Source separation for the Remixer: (bs, 2, T) -> (bs, 4, 2, T) stems.

Port of ``diffmst_tpu/models/separator.py``. The stems come in HDemucs's
order: drums, bass, other, vocals.

  * ``hpss_separator``: spectral masks that need no weights. Median-filter
    harmonic/percussive separation (Fitzgerald, DAFx 2010) gives the drums;
    the harmonic part splits into bass (below 250 Hz), vocals (centre-panned
    content of the vocal band) and other. The four masks sum to 1 in every
    bin, so the stems sum back to the mix up to the STFT round trip.
  * ``UNetSeparator``: a spectrogram U-Net that emits a softmax mask per
    stem, trainable or loaded from the Flax model's weights
    (``utils.checkpoint.unet_state_dict_from_flax``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffmst_torch.ops.stft import istft, stft

__all__ = ["median_filter", "hpss_separator", "UNetSeparator"]


def median_filter(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Running median of odd ``size`` along ``axis``, the edges padded with
    their end samples. The windows are an ``unfold`` view of the padded
    tensor; the median of an odd count is its middle element, so the result
    is JAX's (a median over ``size`` stacked shifts) exactly."""
    if size % 2 != 1:
        raise ValueError(f"median_filter takes an odd size, not {size}")
    half = size // 2
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    idx = torch.arange(-half, n + half, device=x.device).clamp_(0, n - 1)
    windows = x.index_select(-1, idx).unfold(-1, size, 1)  # (..., n, size)
    return windows.median(dim=-1).values.movedim(-1, axis)


def hpss_separator(
    x: torch.Tensor,
    sample_rate: float = 44100.0,
    n_fft: int = 2048,
    hop: int = 512,
    kernel: int = 17,
    power: float = 2.0,
    bass_cutoff_hz: float = 250.0,
    vocal_band_hz: Sequence[float] = (200.0, 12000.0),
) -> torch.Tensor:
    """Mask-based 4-stem separation of a stereo mix: (bs, 2, T) -> (bs, 4, 2, T).

    The masks of a bin (they sum to 1): drums, the percussive soft mask
    (median over frequency against median over time); bass, the harmonic
    mask below the cutoff; vocals, the harmonic mask in the vocal band
    weighted by centre dominance; other, the rest.
    """
    t = x.shape[-1]
    X = stft(x, n_fft, hop)  # (bs, 2, bins, frames)
    mag = X.abs()

    # harmonic energy is smooth in time, percussive energy in frequency
    harm = median_filter(mag, kernel, axis=-1) ** power
    perc = median_filter(mag, kernel, axis=-2) ** power
    denom = harm + perc + 1e-10
    m_perc = perc / denom
    m_harm = harm / denom

    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)

    def band(mask):
        return torch.from_numpy(mask).to(mag.device, mag.dtype)[None, None, :, None]

    low = band(freqs < bass_cutoff_hz)
    m_bass = m_harm * low

    # centre dominance from the mid/side magnitudes, shared by both channels
    mid = (X[:, 0:1] + X[:, 1:2]).abs() / 2.0
    side = (X[:, 0:1] - X[:, 1:2]).abs() / 2.0
    center = torch.clamp((mid - side) / (mid + side + 1e-10), 0.0, 1.0)
    vband = band((freqs >= vocal_band_hz[0]) & (freqs < vocal_band_hz[1]))
    m_voc = m_harm * (1.0 - low) * vband * center

    m_other = 1.0 - m_perc - m_bass - m_voc
    masks = torch.stack([m_perc, m_bass, m_other, m_voc], dim=1)  # HDemucs order
    return istft(X[:, None] * masks, n_fft, hop, length=t)  # (bs, 4, 2, t)


def _same_pad(n: int, k: int, s: int) -> tuple:
    """Flax's "SAME" padding (low, high) of one axis of length n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class UNetSeparator(nn.Module):
    """Spectrogram U-Net emitting softmax masks for ``num_stems`` sources:
    (bs, 2, T) -> (bs, num_stems, 2, T), the channels doubling per level.

    The layers keep the Flax model's creation order: ``convs[i]`` is its
    ``Conv_i`` (per level a 3 x 3 conv, then a 3 x 3 stride-2 conv; per level
    back up, the conv after the skip; last the 1 x 1 head) and ``deconvs[i]``
    its ``ConvTranspose_i``. Flax pads a stride-2 "SAME" conv (0, 1) on an
    even size where torch's ``padding=1`` would pad (1, 1), so every conv
    pads explicitly. The Flax transposed conv, ``transpose_kernel=False``
    with ``lax.conv_transpose``'s "SAME" padding (2, 1), is a correlation of
    the stride-dilated input with its kernel: torch's ``conv_transpose2d``
    with the kernel flipped gives it, one row and column longer, which are
    cut. GELU is Flax's default, the tanh form.
    """

    def __init__(self, num_stems: int = 4, base_width: int = 16, levels: int = 4, n_fft: int = 2048,
                 hop: int = 512):
        super().__init__()
        self.num_stems, self.levels, self.n_fft, self.hop = num_stems, levels, n_fft, hop
        convs, deconvs = [], []
        cin, w = 2, base_width
        for _ in range(levels):
            convs += [nn.Conv2d(cin, w, 3), nn.Conv2d(w, w, 3, stride=2)]
            cin, w = w, w * 2
        for _ in range(levels):
            w //= 2
            deconvs.append(nn.ConvTranspose2d(cin, w, 3, stride=2))
            convs.append(nn.Conv2d(2 * w, w, 3))
            cin = w
        convs.append(nn.Conv2d(cin, num_stems, 1))
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList(deconvs)

    @staticmethod
    def _conv(conv: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
        k, s = conv.kernel_size[0], conv.stride[0]
        (ht, hb), (wl, wr) = (_same_pad(n, k, s) for n in h.shape[-2:])
        return F.gelu(conv(F.pad(h, (wl, wr, ht, hb))), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-1]
        X = stft(x, self.n_fft, self.hop)  # (bs, 2, bins, frames)
        mag = torch.log1p(X.abs())
        bins, frames = mag.shape[-2:]
        div = 2**self.levels
        h = mag[..., : bins - bins % div, : frames - frames % div]  # sizes the pooling divides
        crop_b, crop_f = h.shape[-2:]

        skips = []
        for i in range(self.levels):
            h = self._conv(self.convs[2 * i], h)
            skips.append(h)
            h = self._conv(self.convs[2 * i + 1], h)
        for i, skip in enumerate(reversed(skips)):
            hb, wb = h.shape[-2:]
            h = F.gelu(self.deconvs[i](h)[..., : 2 * hb, : 2 * wb], approximate="tanh")
            h = self._conv(self.convs[2 * self.levels + i], torch.cat([h, skip], dim=1))
        logits = self.convs[-1](h)  # (bs, stems, b', f')
        logits = F.pad(logits, (0, frames - crop_f, 0, bins - crop_b))
        masks = torch.softmax(logits, dim=1)[:, :, None]  # (bs, stems, 1, bins, frames)
        return istft(X[:, None] * masks, self.n_fft, self.hop, length=t)
