"""Training callbacks (port of ``diffmst_tpu/callbacks``): the CSV sink."""

from diffmst_torch.callbacks.metrics import CSVLogger

__all__ = ["CSVLogger"]
