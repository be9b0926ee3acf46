"""Training systems and the loop (port of ``diffmst_tpu/train``)."""

from diffmst_torch.train.param_system import ParameterEstimationSystem, Remixer, band_split_separator
from diffmst_torch.train.system import Batch, EffectFlags, System, SystemConfig, lr_schedule
from diffmst_torch.train.trainer import Trainer

__all__ = [
    "Batch",
    "EffectFlags",
    "System",
    "SystemConfig",
    "Trainer",
    "lr_schedule",
    "ParameterEstimationSystem",
    "Remixer",
    "band_split_separator",
]
