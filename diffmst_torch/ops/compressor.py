"""Feed-forward dynamic range compressor.

Port of ``diffmst_tpu/ops/compressor.py``: a dB-domain level detector, a
quadratic soft-knee static curve, one-pole attack ballistics, a circular-roll
lookahead and makeup gain. Smoothers:

  * ``"fsm"`` — the reference's one-pole applied by frequency sampling
    (circular FFT);
  * ``"scan"`` — the exact causal one-pole through kernel K1
    (``kernels/scan1p.py``), then the gain and the roll in PyTorch;
  * ``"fused"`` — the same numbers through kernel K2
    (``kernels/comp_fused.py``): detector, knee, scan and gain in one pass;
  * ``"auto"`` — ``"fused"``;
  * ``"decoupled"`` — attack/release smoothing with a working release
    (``diffmst_tpu/ops/compressor.py::_smooth_decoupled``:147): the release
    min-scan, kernel K3 (``kernels/scan1p.py::release_min_scan``), then the
    attack one-pole, K1.

The JAX package's names for its Pallas kernels (``diffmst_tpu/ops/
compressor.py``:208, :214, :254) take the port's kernel for the same
function: ``"scan_pallas"`` and ``"scan_pallas_interpret"`` are ``"scan"``
(K1), ``"fused_pallas"`` and ``"fused_pallas_interpret"`` are ``"fused"``
(K2), ``"decoupled_pallas"`` and ``"decoupled_pallas_interpret"`` are
``"decoupled"`` (K3, then K1). Interpret mode, the Pallas kernels' CPU
emulation, has its counterpart in the wrappers' plain versions, which CPU
tensors take.

``"ballistics"`` (a sequential scan in JAX) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from diffmst_torch.kernels.comp_fused import compressor_fused_gain
from diffmst_torch.kernels.scan1p import onepole_core, release_min_scan

__all__ = ["compressor", "compressor_gain_db"]

_LOG9 = math.log(9.0)

# The JAX package's Pallas smoother names, by the port's name for the same path.
_PALLAS_NAMES = {
    "scan_pallas": "scan",
    "scan_pallas_interpret": "scan",
    "fused_pallas": "fused",
    "fused_pallas_interpret": "fused",
    "decoupled_pallas": "decoupled",
    "decoupled_pallas_interpret": "decoupled",
}


def _ballistics_coeff(time_ms: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """One-pole coefficient for a 10%-90% rise time of ``time_ms``."""
    time_samples = sample_rate * (time_ms / 1e3)
    return torch.exp(-_LOG9 / torch.clamp(time_samples, min=1.0))


def _static_gain_db(
    x_db: torch.Tensor,
    threshold_db: torch.Tensor,
    ratio: torch.Tensor,
    knee_db: torch.Tensor,
) -> torch.Tensor:
    """Soft-knee static curve output minus input: the raw gain in dB (<= 0)."""
    over = x_db - threshold_db
    knee = torch.clamp(knee_db, min=1e-3)
    in_knee = (1.0 / ratio - 1.0) * torch.square(over + knee / 2.0) / (2.0 * knee)
    above = (1.0 / ratio - 1.0) * over
    zero = torch.zeros_like(over)
    return torch.where(over <= -knee / 2.0, zero, torch.where(over >= knee / 2.0, above, in_knee))


def _smooth_fsm(g_db: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """One-pole (1 - a) / (1 - a z^-1) applied by frequency sampling on the
    length-T rFFT grid (circular). g_db: (B, T), alpha: (B,)."""
    n = g_db.shape[-1]
    k = torch.fft.rfftfreq(n, device=g_db.device)
    z_inv = torch.exp(-2j * math.pi * k)[None, :].to(torch.complex64)
    a = alpha[:, None]
    H = (1.0 - a) / (1.0 - a * z_inv)
    G = torch.fft.rfft(g_db, n=n, dim=-1)
    return torch.fft.irfft(G * H, n=n, dim=-1)


def compressor_gain_db(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db: torch.Tensor,
    ratio: torch.Tensor,
    attack_ms: torch.Tensor,
    release_ms: torch.Tensor,
    knee_db: torch.Tensor,
    smoother: str = "fsm",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Smoothed gain-reduction envelope in dB for flat (B, T) input.

    The envelope alone has no fused form, so ``"auto"`` takes K1 here
    (``"scan"``). Only the decoupled smoothers read ``release_ms``; the
    attack-only ones ignore it, as the reference does.
    """
    x_db = 20.0 * torch.log10(torch.clamp(torch.abs(x), min=eps))
    g_c = _static_gain_db(x_db, threshold_db[:, None], ratio[:, None], knee_db[:, None])
    alpha_a = _ballistics_coeff(attack_ms, sample_rate)
    smoother = _PALLAS_NAMES.get(smoother, smoother)
    if smoother == "fsm":
        return _smooth_fsm(g_c, alpha_a)
    if smoother in ("scan", "auto"):
        return onepole_core(((1.0 - alpha_a)[:, None] * g_c).contiguous(), alpha_a.contiguous())
    if smoother == "decoupled":
        # release stage y1 = min(g, ar y1[n-1] + (1 - ar) g), then the attack pole
        alpha_r = _ballistics_coeff(release_ms, sample_rate)
        y1 = release_min_scan(g_c.contiguous(), alpha_r.contiguous())
        return onepole_core(((1.0 - alpha_a)[:, None] * y1).contiguous(), alpha_a.contiguous())
    if smoother == "ballistics":
        raise NotImplementedError(
            "compressor smoother 'ballistics' is not ported yet (ROADMAP Queue 1); "
            "use 'decoupled' for a working release, or 'auto', 'fused', 'scan' or 'fsm'"
        )
    raise ValueError(f"unknown smoother: {smoother!r}")


def compressor(
    x: torch.Tensor,
    sample_rate: float,
    threshold_db: torch.Tensor,
    ratio: torch.Tensor,
    attack_ms: torch.Tensor,
    release_ms: torch.Tensor,
    knee_db: torch.Tensor,
    makeup_gain_db: torch.Tensor,
    lookahead_samples: int = 0,
    smoother: str = "fsm",
    eps: float = 1e-8,
) -> torch.Tensor:
    """Compress (batch, channels, time) audio, channels independently.

    Parameters are (batch,) — shared across channels — or (batch, channels).
    With ``lookahead_samples > 0`` the signal the gain is applied to is
    rolled circularly by that many samples relative to the detector, as the
    reference does (torch.roll shifts the same way as jnp.roll).
    """
    bs, chs, seq_len = x.shape

    def bc(p):
        return p.reshape(bs, -1).expand(bs, chs).reshape(bs * chs)

    flat = x.reshape(bs * chs, seq_len)
    smoother = _PALLAS_NAMES.get(smoother, smoother)
    if smoother == "auto":
        # K2 moves the fewest bytes on the card: read x and the delayed x,
        # write the output; the "scan" path adds the envelope's and the
        # gain's round trips through device memory around K1. (The JAX
        # package's "auto" is a TPU v5e measurement and does not carry over.)
        smoother = "fused"
    if smoother == "fused":
        flat = flat.contiguous()
        delayed = torch.roll(flat, lookahead_samples, dims=-1) if lookahead_samples > 0 else flat
        y = compressor_fused_gain(
            flat,
            delayed,
            bc(threshold_db),
            bc(ratio),
            bc(knee_db),
            _ballistics_coeff(bc(attack_ms), sample_rate),
            bc(makeup_gain_db),
            eps,
        )
        return y.reshape(bs, chs, seq_len).to(x.dtype)
    g_s = compressor_gain_db(
        flat,
        sample_rate,
        bc(threshold_db),
        bc(ratio),
        bc(attack_ms),
        bc(release_ms),
        bc(knee_db),
        smoother=smoother,
        eps=eps,
    )
    gain_lin = torch.pow(10.0, (g_s + bc(makeup_gain_db)[:, None]) / 20.0)
    if lookahead_samples > 0:
        flat = torch.roll(flat, lookahead_samples, dims=-1)
    y = flat * gain_lin
    return y.reshape(bs, chs, seq_len).to(x.dtype)
