"""Six-band parametric EQ: frequency sampling, or the exact causal cascade.

Port of ``diffmst_tpu/ops/eq.py``. Methods:

  * ``"fs"`` — the reference's: the cascade's response is sampled on the
    rFFT grid of the whole segment and multiplied in the frequency domain
    (circular convolution);
  * ``"scan"``, ``"scan_pallas"`` and ``"scan_pallas_interpret"`` — the
    causal cascade of the six biquads from zero state
    (``scipy.signal.sosfilt``), through kernel K5 (``kernels/iir_fused.py``)
    on a CUDA tensor and its plain version (``ops/iir.py``) on a CPU tensor.
    The three names take the same path: JAX's "scan" was its XLA scan,
    "scan_pallas" its Pallas kernel and "scan_pallas_interpret" that
    kernel's CPU emulation (``diffmst_tpu/ops/eq.py``:137).
"""

from __future__ import annotations

from typing import Optional

import torch

from diffmst_torch.kernels import iir_fused
from diffmst_torch.ops.biquad import HIGH_SHELF, LOW_SHELF, PEAKING, sos_frequency_response
from diffmst_torch.ops.biquad import biquad as _make_biquad

__all__ = ["parametric_eq", "parametric_eq_response"]


def _eq_sos(
    sample_rate: float,
    low_shelf_gain_db: torch.Tensor,
    low_shelf_cutoff_freq: torch.Tensor,
    low_shelf_q_factor: torch.Tensor,
    band0_gain_db: torch.Tensor,
    band0_cutoff_freq: torch.Tensor,
    band0_q_factor: torch.Tensor,
    band1_gain_db: torch.Tensor,
    band1_cutoff_freq: torch.Tensor,
    band1_q_factor: torch.Tensor,
    band2_gain_db: torch.Tensor,
    band2_cutoff_freq: torch.Tensor,
    band2_q_factor: torch.Tensor,
    band3_gain_db: torch.Tensor,
    band3_cutoff_freq: torch.Tensor,
    band3_q_factor: torch.Tensor,
    high_shelf_gain_db: torch.Tensor,
    high_shelf_cutoff_freq: torch.Tensor,
    high_shelf_q_factor: torch.Tensor,
):
    """The 6 biquad sections: (b, a), each (..., 6, 3)."""
    gains = torch.stack(
        [low_shelf_gain_db, band0_gain_db, band1_gain_db, band2_gain_db,
         band3_gain_db, high_shelf_gain_db], dim=-1,
    )
    freqs = torch.stack(
        [low_shelf_cutoff_freq, band0_cutoff_freq, band1_cutoff_freq,
         band2_cutoff_freq, band3_cutoff_freq, high_shelf_cutoff_freq], dim=-1,
    )
    qs = torch.stack(
        [low_shelf_q_factor, band0_q_factor, band1_q_factor, band2_q_factor,
         band3_q_factor, high_shelf_q_factor], dim=-1,
    )
    b_ls, a_ls = _make_biquad(gains[..., 0], freqs[..., 0], qs[..., 0], sample_rate, LOW_SHELF)
    b_pk, a_pk = _make_biquad(gains[..., 1:5], freqs[..., 1:5], qs[..., 1:5], sample_rate, PEAKING)
    b_hs, a_hs = _make_biquad(gains[..., 5], freqs[..., 5], qs[..., 5], sample_rate, HIGH_SHELF)
    b = torch.cat([b_ls[..., None, :], b_pk, b_hs[..., None, :]], dim=-2)
    a = torch.cat([a_ls[..., None, :], a_pk, a_hs[..., None, :]], dim=-2)
    return b, a


def parametric_eq_response(sample_rate: float, n_fft: int, **eq_params: torch.Tensor) -> torch.Tensor:
    """Complex cascade response on an rFFT grid; shape (..., n_fft // 2 + 1)."""
    b, a = _eq_sos(sample_rate, **eq_params)
    return sos_frequency_response(b, a, n_fft)


def parametric_eq(
    x: torch.Tensor,
    sample_rate: float,
    linear_gain: Optional[torch.Tensor] = None,
    method: str = "fs",
    **eq_params: torch.Tensor,
) -> torch.Tensor:
    """Apply the 6-band EQ to (batch, channels, time) audio.

    ``linear_gain`` (batch,) is a fader: folded into the sampled response
    under ``"fs"``, applied to the signal before the cascade under the
    causal methods. Each of the 18 band parameters has shape (batch,),
    shared across channels.
    """
    n = x.shape[-1]
    if method in ("scan", "scan_pallas", "scan_pallas_interpret"):
        bs, chs, _ = x.shape
        b, a = _eq_sos(sample_rate, **eq_params)  # (bs, 6, 3)
        flat = x.reshape(bs * chs, n)
        if linear_gain is not None:
            flat = flat * linear_gain.repeat_interleave(chs)[:, None]
        y = iir_fused.sosfilt(
            flat.contiguous(), b.repeat_interleave(chs, dim=0), a.repeat_interleave(chs, dim=0)
        )
        return y.reshape(bs, chs, n).to(x.dtype)
    if method != "fs":
        raise ValueError(f"unknown eq method: {method!r}")
    H = parametric_eq_response(sample_rate, n, **eq_params)  # (batch, bins)
    if linear_gain is not None:
        H = H * linear_gain[:, None].to(H.real.dtype)
    X = torch.fft.rfft(x, n=n, dim=-1)
    y = torch.fft.irfft(X * H[:, None, :], n=n, dim=-1)
    return y.to(x.dtype)
