"""Audio utilities: peak normalization, crops and fades (port of
``diffmst_tpu/utils/audio.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "batch_stereo_peak_normalize",
    "center_crop",
    "causal_crop",
    "fade_in_and_fade_out",
]


def batch_stereo_peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """Divide each batch item of (bs, chs, T) by its max |peak| across
    channels and time (at least 1e-8)."""
    peak = torch.amax(torch.abs(x), dim=(-2, -1), keepdim=True)
    return x / torch.clamp(peak, min=1e-8)


def center_crop(x: torch.Tensor, length: int) -> torch.Tensor:
    """The middle ``length`` samples of the last axis (the earlier one where
    the excess is odd)."""
    if x.shape[-1] == length:
        return x
    start = (x.shape[-1] - length) // 2
    return x[..., start : start + length]


def causal_crop(x: torch.Tensor, length: int) -> torch.Tensor:
    """The ``length`` samples of the last axis that end one before its last:
    the window [T - 1 - length, T - 1), as JAX's (and the reference's)."""
    if x.shape[-1] == length:
        return x
    stop = x.shape[-1] - 1
    return x[..., stop - length : stop]


def fade_in_and_fade_out(x: torch.Tensor, fade_ms: float = 10.0, sample_rate: float = 44100.0) -> torch.Tensor:
    """A new tensor: x with linear ramps over its first and last
    ``fade_ms`` milliseconds (0 to 1 in, 1 to 0 out); x is not edited."""
    n = int(fade_ms * 1e-3 * sample_rate)
    x = x.clone()
    x[..., :n] *= _linspace(0.0, 1.0, n, x)
    x[..., -n:] *= _linspace(1.0, 0.0, n, x)
    return x


def _linspace(start: float, stop: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` bitwise, in ``like``'s dtype: start *
    (1 - s) + stop * s at s = i / (n - 1), and ``stop`` last."""
    if n < 2:
        return torch.full((n,), start, dtype=like.dtype, device=like.device)
    step = torch.arange(n - 1, dtype=like.dtype, device=like.device) / (n - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, out.new_full((1,), stop)])
