"""Evaluation-only audio metrics: SI-SDR and the MRSTFT distance.

Port of ``diffmst_tpu/losses/eval_metrics.py``. The reference builds these
in its System but leaves the logging that would use them commented out;
here they are working functions for evaluation scripts.
"""

from __future__ import annotations

import torch

from diffmst_torch.losses.mrstft import MultiResolutionSTFTLoss

__all__ = ["si_sdr", "mrstft_distance"]


def si_sdr(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis, averaged over the rest
    (Le Roux et al. 2019): the estimate's projection onto the target against
    the residual."""
    pred = pred - torch.mean(pred, dim=-1, keepdim=True)
    target = target - torch.mean(target, dim=-1, keepdim=True)
    dot = torch.sum(pred * target, dim=-1, keepdim=True)
    energy = torch.sum(torch.square(target), dim=-1, keepdim=True)
    s_target = dot / torch.maximum(energy, energy.new_tensor(eps)) * target
    e_noise = pred - s_target
    ratio = torch.sum(torch.square(s_target), dim=-1) / torch.maximum(
        torch.sum(torch.square(e_noise), dim=-1), pred.new_tensor(eps)
    )
    return torch.mean(10.0 * torch.log10(torch.maximum(ratio, ratio.new_tensor(eps))))


_EVAL_MRSTFT = MultiResolutionSTFTLoss()


def mrstft_distance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MRSTFT distance at the training resolutions (512, 2048, 8192)."""
    return _EVAL_MRSTFT(pred, target)
