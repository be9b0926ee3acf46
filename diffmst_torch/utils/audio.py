"""Audio utilities (port of ``diffmst_tpu/utils/audio.py``, the part the
training step uses)."""

from __future__ import annotations

import torch

__all__ = ["batch_stereo_peak_normalize"]


def batch_stereo_peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """Divide each batch item of (bs, chs, T) by its max |peak| across
    channels and time (at least 1e-8)."""
    peak = torch.amax(torch.abs(x), dim=(-2, -1), keepdim=True)
    return x / torch.clamp(peak, min=1e-8)
