"""Models (port of ``diffmst_tpu/models``)."""

from diffmst_torch.models.cnn14 import Cnn14, ConvBlock
from diffmst_torch.models.controller import TransformerController
from diffmst_torch.models.encoders import PositionalEncoding, SpectrogramEncoder, WaveformTransformerEncoder
from diffmst_torch.models.fx_encoder import FXencoder, ParameterProjector, default_fx_encoder_config
from diffmst_torch.models.hdemucs import (
    HDEMUCS_SOURCES,
    HDemucs,
    make_hdemucs_separator,
    synthetic_hdemucs_state_dict,
)
from diffmst_torch.models.mst_model import MixStyleTransferModel
from diffmst_torch.models.separator import UNetSeparator, hpss_separator, median_filter
from diffmst_torch.models.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = [
    "hpss_separator",
    "median_filter",
    "UNetSeparator",
    "HDEMUCS_SOURCES",
    "HDemucs",
    "make_hdemucs_separator",
    "synthetic_hdemucs_state_dict",
    "Cnn14",
    "ConvBlock",
    "TransformerController",
    "SpectrogramEncoder",
    "WaveformTransformerEncoder",
    "PositionalEncoding",
    "FXencoder",
    "ParameterProjector",
    "default_fx_encoder_config",
    "MixStyleTransferModel",
    "TransformerEncoder",
    "TransformerEncoderLayer",
]
