"""Elementwise console primitives: gain, constant-power panner, mono to
stereo, and the fx bus's send sum.

Port of ``diffmst_tpu/ops/basic.py``. Parameters are per batch item and
broadcast over channels and time.
"""

from __future__ import annotations

import math

import torch

__all__ = ["db_to_linear", "gain", "stereo_panner", "mono_to_stereo", "stereo_bus"]


def db_to_linear(gain_db: torch.Tensor) -> torch.Tensor:
    """Convert decibels to a linear amplitude ratio."""
    return torch.pow(10.0, gain_db / 20.0)


def gain(x: torch.Tensor, sample_rate: float, gain_db: torch.Tensor) -> torch.Tensor:
    """Scale (batch, channels, time) audio by ``gain_db`` of shape (batch,)
    or (batch, channels). ``sample_rate`` is unused (uniform signature)."""
    del sample_rate
    g = db_to_linear(gain_db.reshape(x.shape[0], -1))
    return x * g[:, :, None]


_HALF_PI = math.pi / 2.0
_TWO_OVER_PI = 2.0 / math.pi


def stereo_panner(x: torch.Tensor, sample_rate: float, pan: torch.Tensor) -> torch.Tensor:
    """Pan mono tracks with the -4.5 dB compromise law.

    theta = pan * pi/2; left = sqrt((pi/2 - theta) * 2/pi * cos theta);
    right = sqrt(theta * 2/pi * sin theta).

    Args:
      x: (batch, num_tracks, time) mono tracks.
      pan: (batch, num_tracks) positions in [0, 1].

    Returns:
      (batch, 2, num_tracks, time) stereo tracks.
    """
    del sample_rate
    theta = pan * _HALF_PI
    left = torch.sqrt((_HALF_PI - theta) * _TWO_OVER_PI * torch.cos(theta))
    right = torch.sqrt(theta * _TWO_OVER_PI * torch.sin(theta))
    gains = torch.stack([left, right], dim=1)  # (batch, 2, num_tracks)
    return x[:, None, :, :] * gains[:, :, :, None]


def mono_to_stereo(x: torch.Tensor) -> torch.Tensor:
    """(batch, num_tracks, time) -> (batch, 2, num_tracks, time), duplicated."""
    return x[:, None, :, :].expand(x.shape[0], 2, *x.shape[1:])


def stereo_bus(x: torch.Tensor, sample_rate: float, send_db: torch.Tensor) -> torch.Tensor:
    """Sum panned tracks into a stereo bus, each at its send level.

    Args:
      x: (batch, 2, num_tracks, time) panned tracks.
      sample_rate: unused (uniform signature).
      send_db: (batch, num_tracks) send levels in dB.

    Returns:
      (batch, 2, time) stereo bus.
    """
    del sample_rate
    return torch.einsum("bcnt,bn->bct", x, db_to_linear(send_db))
