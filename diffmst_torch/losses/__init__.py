"""Losses (port of ``diffmst_tpu/losses``)."""

from diffmst_torch.losses.mrstft import MultiResolutionSTFTLoss, stft_loss

__all__ = ["MultiResolutionSTFTLoss", "stft_loss"]
