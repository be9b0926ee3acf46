"""Losses (port of ``diffmst_tpu/losses``)."""

from diffmst_torch.losses.eval_metrics import mrstft_distance, si_sdr
from diffmst_torch.losses.features import (
    AudioFeatureLoss,
    compute_barkspectrum,
    compute_crest_factor,
    compute_melspectrum,
    compute_rms,
    compute_stereo_imbalance,
    compute_stereo_width,
)
from diffmst_torch.losses.filterbank import bark_to_hz, barkscale_fbanks, hz_to_bark
from diffmst_torch.losses.mrstft import MultiResolutionSTFTLoss, stft_loss

__all__ = [
    "AudioFeatureLoss",
    "MultiResolutionSTFTLoss",
    "stft_loss",
    "si_sdr",
    "mrstft_distance",
    "compute_rms",
    "compute_crest_factor",
    "compute_stereo_width",
    "compute_stereo_imbalance",
    "compute_barkspectrum",
    "compute_melspectrum",
    "barkscale_fbanks",
    "bark_to_hz",
    "hz_to_bark",
]
