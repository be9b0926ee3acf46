"""Hybrid Demucs (HDemucs v3) source separation, the Remixer's separator.

Port of ``diffmst_tpu/models/hdemucs.py`` (Defossez, "Hybrid Spectrogram
and Waveform Source Separation", 2021; the architecture torchaudio ships as
HDEMUCS_HIGH_MUSDB_PLUS, which the reference's Remixer separates with,
mst/modules.py:496-500). ``HDemucs`` is an ``nn.Module`` whose
``state_dict()`` has the keys and shapes of ``synthetic_hdemucs_state_dict``,
torchaudio's inventory, so a torchaudio weights file loads into it with
``load_state_dict(strict=True)`` (``utils.checkpoint.load_hdemucs_checkpoint``).

The forward is JAX's ``hdemucs_apply``, in its order:

  * spectral branch: a reflect-padded normalized STFT as complex-as-channels,
    z-normalized; frequency encoders 2048 -> 512 -> 128 -> 32 -> 8 -> 1 bins
    and one time-conv encoder; the frequency embedding (x 0.2, scale 10)
    after layer 0;
  * time branch: waveform encoders of stride 4, the last one empty (a conv
    only) and added into the spectral branch where the frame rates meet;
  * mirrored decoders with skips; the time branch leaves the spectral one
    at the same layer; the spectral output is a complex mask -> iSTFT; the
    two branches' outputs, denormalized, sum.

The z-normalizations divide by the biased standard deviation (ddof 0), as
JAX's do; torchaudio's ``.std()`` is unbiased (ddof 1). Over the elements
reduced the two differ by about 1 / (2N) relative, 1e-7 for a second of
audio. The LSTMs are ``nn.LSTM`` (cuDNN on the card): torch's gate order
and weight layout are the state dict's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffmst_torch.ops.stft import istft, reflect_pad, stft
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["HDEMUCS_SOURCES", "HDemucs", "make_hdemucs_separator", "synthetic_hdemucs_state_dict"]

# torchaudio HDEMUCS_HIGH_MUSDB_PLUS stem order (mst/modules.py:496-500)
HDEMUCS_SOURCES = ("drums", "bass", "other", "vocals")

_EPS_NORM = 1e-5  # z-normalization epsilon (demucs forward)
_FREQ_EMB_WEIGHT = 0.2
_EMB_SCALE = 10.0  # ScaledEmbedding scale
_LSTM_MAX_STEPS = 200


def _pad1d(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """demucs's reflect pad1d: an input no longer than the pad is
    zero-extended first."""
    length = x.shape[-1]
    max_pad = max(left, right)
    if length <= max_pad:
        extra = max_pad - length + 1
        extra_r = min(right, extra)
        extra_l = extra - extra_r
        x = F.pad(x, (extra_l, extra_r))
        left, right = left - extra_l, right - extra_r
    return reflect_pad(x, left, right)


def _spec(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """demucs _spec: reflect pad, normalized STFT, the Nyquist bin dropped,
    ceil(T / hop) frames kept."""
    hop = nfft // 4
    length = x.shape[-1]
    le = int(math.ceil(length / hop))
    pad = hop // 2 * 3
    x = _pad1d(x, pad, pad + le * hop - length)
    z = stft(x, nfft, hop) * (1.0 / math.sqrt(nfft))  # torch normalized=True
    return z[..., :-1, 2: 2 + le]


def _ispec(z: torch.Tensor, length: int, nfft: int) -> torch.Tensor:
    """demucs _ispec: the Nyquist bin and 2 frames each side back, iSTFT, trim."""
    hop = nfft // 4
    z = torch.view_as_complex(F.pad(torch.view_as_real(z), (0, 0, 2, 2, 0, 1)).contiguous())
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    x = istft(z * math.sqrt(nfft), nfft, hop, length=le)
    return x[..., pad: pad + length]


class _LayerScale(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale[None, :, None] * x


class _BLSTM(nn.Module):
    """demucs BLSTM(layers=2, max_steps=200, skip=True) on (B, C, T): inputs
    longer than 200 steps run as frames of 200 at stride 100, each frame's
    outer 50 steps dropped where a neighbour covers them."""

    def __init__(self, dim: int, layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=layers, bidirectional=True)
        self.linear = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        y = x
        width, stride = _LSTM_MAX_STEPS, _LSTM_MAX_STEPS // 2
        framed = t > width
        if framed:
            n_frames = int(math.ceil(t / stride))
            xp = F.pad(x, (0, (n_frames - 1) * stride + width - t))
            x = xp.unfold(-1, width, stride).transpose(1, 2).reshape(-1, c, width)  # (B * n, C, width)
        if x.is_cuda:
            self.lstm.flatten_parameters()
        h, _ = self.lstm(x.permute(2, 0, 1))  # (T', B', 2C)
        x = self.linear(h).permute(1, 2, 0)  # (B', C, T')
        if framed:
            frames = x.reshape(b, -1, c, width)
            limit = stride // 2
            out = [frames[:, 0, :, :-limit]]
            out += [frames[:, k, :, limit:-limit] for k in range(1, n_frames - 1)]
            out.append(frames[:, n_frames - 1, :, limit:])
            x = torch.cat(out, dim=-1)[..., :t]
        return x + y


class _LocalState(nn.Module):
    """demucs LocalState: local attention over time with ``ndecay`` learned
    decays, on (B, C, T)."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(channels, channels, 1)
        self.query = nn.Conv1d(channels, channels, 1)
        self.key = nn.Conv1d(channels, channels, 1)
        self.query_decay = nn.Conv1d(channels, heads * ndecay, 1)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t = x.shape
        heads = self.heads
        queries = self.query(x).reshape(b, heads, -1, t)
        keys = self.key(x).reshape(b, heads, -1, t)
        dots = torch.einsum("bhct,bhcs->bhts", keys, queries) / math.sqrt(keys.shape[2])
        if self.ndecay:
            decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
            decay_q = torch.sigmoid(self.query_decay(x).reshape(b, heads, -1, t)) / 2
            idx = torch.arange(t, device=x.device, dtype=x.dtype)
            delta = (idx[:, None] - idx[None, :]).abs()
            decay_kernel = -decays[:, None, None] * delta[None] / math.sqrt(self.ndecay)
            dots = dots + torch.einsum("fts,bhfs->bhts", decay_kernel, decay_q)
        eye = torch.eye(t, dtype=torch.bool, device=x.device)
        dots = dots.masked_fill(eye, -100.0)
        weights = torch.softmax(dots, dim=2)
        content = self.content(x).reshape(b, heads, -1, t)
        result = torch.einsum("bhts,bhct->bhcs", weights, content).reshape(b, -1, t)
        return x + self.proj(result)


class _DConv(nn.Module):
    """demucs DConv: residual branches of dilated convs on (B, C, T), the
    dilation doubling per branch. A branch's ``nn.Sequential`` indices are
    the state dict's: 0 conv, 1 norm, 2 GELU, [3 BLSTM, 4 LocalState,]
    conv 1 x 1, norm, GLU, LayerScale."""

    def __init__(self, channels: int, depth: int, compress: int, lstm: bool, attn: bool, heads: int,
                 ndecay: int):
        super().__init__()
        hidden = channels // compress
        layers = []
        for d in range(depth):
            dil = 2**d
            mods = [nn.Conv1d(channels, hidden, 3, dilation=dil, padding=dil), nn.GroupNorm(1, hidden), nn.GELU()]
            if lstm:
                mods.append(_BLSTM(hidden))
            if attn:
                mods.append(_LocalState(hidden, heads, ndecay))
            mods += [nn.Conv1d(hidden, 2 * channels, 1), nn.GroupNorm(1, 2 * channels), nn.GLU(1),
                     _LayerScale(channels)]
            layers.append(nn.Sequential(*mods))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for branch in self.layers:
            x = x + branch(x)
        return x


def _time_stride_pad(kernel: int, stride: int, time_stride: int):
    """A time layer's (stride, pad): the kernel of 2 x time_stride strides by
    time_stride and pads 1, any other by ``stride`` and ``kernel // 4``."""
    return (time_stride, 1) if kernel == 2 * time_stride else (stride, kernel // 4)


class _HEncLayer(nn.Module):
    """HEncLayer: conv [-> inject -> norm1 -> GELU -> DConv -> rewrite ->
    norm2 -> GLU]; an ``empty`` layer is the conv alone."""

    def __init__(self, chin: int, chout: int, kernel: int, freq: bool, empty: bool, norm: bool,
                 norm_groups: int, dconv: Optional[_DConv], stride: int = 4, time_stride: int = 2,
                 last_freq: bool = False):
        super().__init__()
        self.freq, self.empty = freq, empty
        if freq:
            pad = 0 if last_freq else kernel // 4
            self.conv = nn.Conv2d(chin, chout, (kernel, 1), (stride, 1), (pad, 0))
            self.stride = stride
        else:
            self.stride, pad = _time_stride_pad(kernel, stride, time_stride)
            self.conv = nn.Conv1d(chin, chout, kernel, self.stride, pad)
        self.norm1 = nn.GroupNorm(norm_groups, chout) if norm else nn.Identity()
        if not empty:
            self.rewrite = (nn.Conv2d if freq else nn.Conv1d)(chout, 2 * chout, 1)
            self.norm2 = nn.GroupNorm(norm_groups, 2 * chout) if norm else nn.Identity()
            self.dconv = dconv

    def forward(self, x: torch.Tensor, inject: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.freq:
            if x.dim() == 4:
                x = x.reshape(x.shape[0], -1, x.shape[-1])
            le = x.shape[-1]
            if le % self.stride:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            if inject.dim() == 3 and y.dim() == 4:
                inject = inject[:, :, None]
            y = y + inject
        y = F.gelu(self.norm1(y))
        if self.dconv is not None:
            if self.freq:
                b, c, fr, t = y.shape
                y = self.dconv(y.transpose(1, 2).reshape(-1, c, t)).reshape(b, fr, c, t).transpose(1, 2)
            else:
                y = self.dconv(y)
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class _HDecLayer(nn.Module):
    """HDecLayer: [skip add -> rewrite -> norm1 -> GLU ->] transposed conv ->
    norm2 -> trim [-> GELU]; returns (z, the transposed conv's input)."""

    def __init__(self, chin: int, chout: int, kernel: int, freq: bool, empty: bool, norm1: bool, norm2: bool,
                 norm_groups: int, stride: int = 4, time_stride: int = 2, last_freq: bool = False):
        super().__init__()
        self.freq, self.empty, self.chin = freq, empty, chin
        if freq:
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel, 1), (stride, 1))
            self.pad = 0 if last_freq else kernel // 4
        else:
            st, self.pad = _time_stride_pad(kernel, stride, time_stride)
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel, st)
        self.norm2 = nn.GroupNorm(norm_groups, chout) if norm2 else nn.Identity()
        if not empty:
            self.rewrite = (nn.Conv2d if freq else nn.Conv1d)(chin, 2 * chin, 3, padding=1)
            self.norm1 = nn.GroupNorm(norm_groups, 2 * chin) if norm1 else nn.Identity()

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor], length: int, last: bool = False):
        if self.freq and x.dim() == 3:
            x = x.reshape(x.shape[0], self.chin, -1, x.shape[-1])
        y = x if self.empty else F.glu(self.norm1(self.rewrite(x + skip)), dim=1)
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            if self.pad:
                z = z[..., self.pad:-self.pad, :]
        else:
            z = z[..., self.pad: self.pad + length]
        if not last:
            z = F.gelu(z)
        return z, y


class _ScaledEmbedding(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num, dim)


class HDemucs(nn.Module):
    """HDemucs: (B, audio_channels, T) stereo mix -> (B, n_sources, audio_channels,
    T) stems. The arguments are torchaudio's HDEMUCS_HIGH defaults; the layers
    are built in ``synthetic_hdemucs_state_dict``'s order, which is
    torchaudio's."""

    def __init__(self, channels: int = 48, depth: int = 6, audio_channels: int = 2, n_sources: int = 4,
                 nfft: int = 4096, norm_starts: int = 4, dconv_lstm: int = 4, dconv_attn: int = 4,
                 dconv_depth: int = 2, dconv_comp: int = 4, heads: int = 4, ndecay: int = 4,
                 kernel_size: int = 8, time_stride: int = 2, norm_groups: int = 4):
        super().__init__()
        self.nfft = nfft
        freqs = nfft // 2
        chin_z, chin_t = audio_channels * 2, audio_channels
        encoder, decoder, tencoder, tdecoder = [], [], [], []
        for idx in range(depth):
            norm = idx >= norm_starts
            freq = freqs > 1
            last_freq = freq and freqs <= kernel_size
            chout = channels if idx == 0 else chin_z * 2

            def dconv(ch):
                return _DConv(ch, dconv_depth, dconv_comp, idx >= dconv_lstm, idx >= dconv_attn, heads, ndecay)

            ker = (freqs if last_freq else kernel_size) if freq else time_stride * 2
            geometry = dict(stride=4, time_stride=time_stride, last_freq=last_freq)
            encoder.append(_HEncLayer(chin_z, chout, ker, freq, False, norm, norm_groups, dconv(chout), **geometry))
            dec_chout = chin_z if idx > 0 else n_sources * audio_channels * 2
            decoder.insert(0, _HDecLayer(chout, dec_chout, ker, freq, False, norm, norm, norm_groups, **geometry))
            if freq:  # the matching time-branch layers; the last_freq one is empty
                tencoder.append(_HEncLayer(chin_t, chout, kernel_size, False, last_freq, False, norm_groups,
                                           None if last_freq else dconv(chout), 4, time_stride))
                tdec_chout = chin_z if idx > 0 else n_sources * audio_channels
                tdecoder.insert(0, _HDecLayer(chout, tdec_chout, kernel_size, False, last_freq, False, norm,
                                              norm_groups, 4, time_stride))
                chin_t = chout
            if idx == 0:
                self.freq_emb = _ScaledEmbedding(freqs // 4, chout)
            chin_z = chout
            if freq:
                freqs //= 4 if not last_freq else freqs
        self.encoder = nn.ModuleList(encoder)
        self.decoder = nn.ModuleList(decoder)
        self.tencoder = nn.ModuleList(tencoder)
        self.tdecoder = nn.ModuleList(tdecoder)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        length, b = mix.shape[-1], mix.shape[0]
        z = _spec(mix, self.nfft)  # (B, C, nfft // 2, frames) complex
        mag = torch.stack([z.real, z.imag], dim=2).reshape(b, -1, *z.shape[-2:])  # [c0 re, c0 im, c1 re, ...]

        # biased standard deviations, as JAX's (torchaudio's are unbiased)
        std, mean = torch.std_mean(mag, dim=(1, 2, 3), keepdim=True, correction=0)
        x = (mag - mean) / (_EPS_NORM + std)
        stdt, meant = torch.std_mean(mix, dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (_EPS_NORM + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, enc in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.tencoder[idx]
                xt = tenc(xt)
                if tenc.empty:
                    inject = xt  # the empty time layer joins the spectral branch
                else:
                    saved_t.append(xt)
            x = enc(x, inject)
            if idx == 0:
                emb = (self.freq_emb.embedding.weight * _EMB_SCALE).t()[None, :, :, None]
                x = x + _FREQ_EMB_WEIGHT * emb
            saved.append(x)

        depth = len(self.decoder)
        offset = depth - len(self.tdecoder)
        xt_out = None
        for idx, dec in enumerate(self.decoder):
            last = idx == depth - 1
            x, pre = dec(x, saved.pop(-1), lengths.pop(-1), last)
            if idx >= offset:
                tdec = self.tdecoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tdec.empty:  # seeded from the spectral branch
                    xt_out, _ = tdec(pre[:, :, 0], None, length_t)
                else:
                    xt_out, _ = tdec(xt_out, saved_t.pop(-1), length_t, last)

        n_src = x.shape[1] // mag.shape[1]
        x = x.reshape(b, n_src, -1, *x.shape[-2:]) * std[:, None] + mean[:, None]
        m = x.reshape(b, n_src, -1, 2, *x.shape[-2:])
        x_wave = _ispec(torch.complex(m[:, :, :, 0], m[:, :, :, 1]), length, self.nfft)  # (B, S, C, T)
        xt_out = xt_out.reshape(b, n_src, -1, length) * stdt[:, None] + meant[:, None]
        return xt_out + x_wave


def make_hdemucs_separator(state_dict: Dict, device: DeviceLike = None, **hdemucs_kwargs) -> HDemucs:
    """An ``HDemucs`` (``hdemucs_kwargs``, default HDEMUCS_HIGH) with a
    torch-layout state dict loaded strictly, in eval mode on ``device`` (None:
    the CUDA device): the Remixer's (bs, 2, T) -> (bs, 4, 2, T) separator."""
    from diffmst_torch.utils.checkpoint import port_hdemucs_state_dict

    model = HDemucs(**hdemucs_kwargs)
    port_hdemucs_state_dict(state_dict, model)
    return model.eval().to(resolve_device(device))


# ------------------------------------------------- synthetic checkpoint
def synthetic_hdemucs_state_dict(
    channels: int = 48,
    depth: int = 6,
    audio_channels: int = 2,
    n_sources: int = 4,
    nfft: int = 4096,
    norm_starts: int = 4,
    dconv_lstm: int = 4,
    dconv_attn: int = 4,
    dconv_depth: int = 2,
    dconv_comp: int = 4,
    heads: int = 4,
    ndecay: int = 4,
    kernel_size: int = 8,
    time_stride: int = 2,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """A torch-layout HDemucs ``state_dict`` with torchaudio's key inventory
    and shapes and N(0, 0.05) float32 values from ``np.random.default_rng(seed)``,
    key for key and bitwise JAX's: the weights of the port's tests and of
    ``chip_smoke.py``, since no pretrained file is at hand."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def t(name, *shape):
        sd[name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def group_norm(prefix, ch):
        t(prefix + ".weight", ch)
        t(prefix + ".bias", ch)

    def dconv(prefix, ch, lstm, attn):
        hidden = ch // dconv_comp
        for d in range(dconv_depth):
            base = f"{prefix}.layers.{d}"
            t(f"{base}.0.weight", hidden, ch, 3)
            t(f"{base}.0.bias", hidden)
            group_norm(f"{base}.1", hidden)
            i = 3
            if lstm:
                lp = f"{base}.{i}.lstm"
                for layer in range(2):
                    ih = hidden if layer == 0 else 2 * hidden
                    for sfx in ("", "_reverse"):
                        t(f"{lp}.weight_ih_l{layer}{sfx}", 4 * hidden, ih)
                        t(f"{lp}.weight_hh_l{layer}{sfx}", 4 * hidden, hidden)
                        t(f"{lp}.bias_ih_l{layer}{sfx}", 4 * hidden)
                        t(f"{lp}.bias_hh_l{layer}{sfx}", 4 * hidden)
                t(f"{base}.{i}.linear.weight", hidden, 2 * hidden)
                t(f"{base}.{i}.linear.bias", hidden)
                i += 1
            if attn:
                ap = f"{base}.{i}"
                for nm in ("content", "query", "key"):
                    t(f"{ap}.{nm}.weight", hidden, hidden, 1)
                    t(f"{ap}.{nm}.bias", hidden)
                t(f"{ap}.query_decay.weight", heads * ndecay, hidden, 1)
                t(f"{ap}.query_decay.bias", heads * ndecay)
                t(f"{ap}.proj.weight", hidden, hidden, 1)
                t(f"{ap}.proj.bias", hidden)
                i += 1
            t(f"{base}.{i}.weight", 2 * ch, hidden, 1)
            t(f"{base}.{i}.bias", 2 * ch)
            group_norm(f"{base}.{i + 1}", 2 * ch)
            t(f"{base}.{i + 3}.scale", ch)

    freqs = nfft // 2
    chin_z, chin_t = audio_channels * 2, audio_channels
    ch = channels

    # tdecoder holds one layer per frequency encoder layer, inserted at index
    # 0 as the layers are built, so tdecoder.0 mirrors the deepest one
    n_freq, f = 0, freqs
    while f > 1:
        n_freq += 1
        f = 1 if f <= kernel_size else f // 4
    for idx in range(depth):
        lstm = idx >= dconv_lstm
        attn = idx >= dconv_attn
        norm = idx >= norm_starts
        freq = freqs > 1
        last_freq = freq and freqs <= kernel_size
        chout = ch if idx == 0 else chin_z * 2

        ep = f"encoder.{idx}"
        if freq:
            ker = freqs if last_freq else kernel_size
            t(f"{ep}.conv.weight", chout, chin_z, ker, 1)
            t(f"{ep}.conv.bias", chout)
            if norm:
                group_norm(f"{ep}.norm1", chout)
            t(f"{ep}.rewrite.weight", 2 * chout, chout, 1, 1)
            t(f"{ep}.rewrite.bias", 2 * chout)
            if norm:
                group_norm(f"{ep}.norm2", 2 * chout)
        else:
            t(f"{ep}.conv.weight", chout, chin_z, time_stride * 2)
            t(f"{ep}.conv.bias", chout)
            if norm:
                group_norm(f"{ep}.norm1", chout)
            t(f"{ep}.rewrite.weight", 2 * chout, chout, 1)
            t(f"{ep}.rewrite.bias", 2 * chout)
            if norm:
                group_norm(f"{ep}.norm2", 2 * chout)
        dconv(f"{ep}.dconv", chout, lstm, attn)

        if freq:  # matching time-branch encoder
            tp = f"tencoder.{idx}"
            t(f"{tp}.conv.weight", chout, chin_t, kernel_size)
            t(f"{tp}.conv.bias", chout)
            if not last_freq:
                t(f"{tp}.rewrite.weight", 2 * chout, chout, 1)
                t(f"{tp}.rewrite.bias", 2 * chout)
                dconv(f"{tp}.dconv", chout, lstm, attn)
            chin_t = chout

        # mirrored decoder layer: decoder.{depth - 1 - idx}
        dp = f"decoder.{depth - 1 - idx}"
        dec_chout = chin_z if idx > 0 else n_sources * audio_channels * 2
        if freq:
            ker = freqs if last_freq else kernel_size
            t(f"{dp}.conv_tr.weight", chout, dec_chout, ker, 1)
            t(f"{dp}.conv_tr.bias", dec_chout)
            if norm:
                group_norm(f"{dp}.norm2", dec_chout)
            t(f"{dp}.rewrite.weight", 2 * chout, chout, 3, 3)
            t(f"{dp}.rewrite.bias", 2 * chout)
            if norm:
                group_norm(f"{dp}.norm1", 2 * chout)
        else:
            t(f"{dp}.conv_tr.weight", chout, dec_chout, time_stride * 2)
            t(f"{dp}.conv_tr.bias", dec_chout)
            if norm:
                group_norm(f"{dp}.norm2", dec_chout)
            t(f"{dp}.rewrite.weight", 2 * chout, chout, 3)
            t(f"{dp}.rewrite.bias", 2 * chout)
            if norm:
                group_norm(f"{dp}.norm1", 2 * chout)

        if freq:  # mirrored time decoder: tdecoder.{n_freq - 1 - idx}
            tdp = f"tdecoder.{n_freq - 1 - idx}"
            tdec_chout = chin_z if idx > 0 else n_sources * audio_channels
            t(f"{tdp}.conv_tr.weight", chout, tdec_chout, kernel_size)
            t(f"{tdp}.conv_tr.bias", tdec_chout)
            if norm:
                group_norm(f"{tdp}.norm2", tdec_chout)
            if not last_freq:
                t(f"{tdp}.rewrite.weight", 2 * chout, chout, 3)
                t(f"{tdp}.rewrite.bias", 2 * chout)

        if idx == 0:
            t("freq_emb.embedding.weight", freqs // 4, chout)
        chin_z = chout
        if freq:
            freqs //= 4 if not last_freq else freqs

    return sd
