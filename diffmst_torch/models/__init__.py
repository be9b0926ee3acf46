"""Models (port of ``diffmst_tpu/models``)."""

from diffmst_torch.models.cnn14 import Cnn14, ConvBlock
from diffmst_torch.models.controller import TransformerController
from diffmst_torch.models.encoders import SpectrogramEncoder
from diffmst_torch.models.mst_model import MixStyleTransferModel
from diffmst_torch.models.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = [
    "Cnn14",
    "ConvBlock",
    "TransformerController",
    "SpectrogramEncoder",
    "MixStyleTransferModel",
    "TransformerEncoder",
    "TransformerEncoderLayer",
]
