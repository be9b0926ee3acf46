"""The host-side data pipeline (port of ``diffmst_tpu/data``)."""

from diffmst_torch.data.audio_io import UnsupportedAudioFormat, audio_info, read_audio, write_audio
from diffmst_torch.data.dataset import MixDataModule, MixDataset, MultitrackDataModule, MultitrackDataset, TrackExample

__all__ = [
    "UnsupportedAudioFormat",
    "audio_info",
    "read_audio",
    "write_audio",
    "MixDataModule",
    "MixDataset",
    "MultitrackDataModule",
    "MultitrackDataset",
    "TrackExample",
]
