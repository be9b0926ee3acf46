"""Training callbacks (port of ``diffmst_tpu/callbacks``): metric sinks,
audio logging and plotting helpers."""

from diffmst_torch.callbacks.audio import LogAudioCallback, LogReferenceMix
from diffmst_torch.callbacks.metrics import CSVLogger, WandbLogger
from diffmst_torch.callbacks.plotting import fig2img, plot_confusion_matrix, plot_spectrograms

__all__ = [
    "LogAudioCallback", "LogReferenceMix", "CSVLogger", "WandbLogger",
    "plot_spectrograms", "plot_confusion_matrix", "fig2img",
]
