"""Training systems (port of ``diffmst_tpu/train``)."""

from diffmst_torch.train.system import Batch, EffectFlags, System, SystemConfig, lr_schedule

__all__ = ["Batch", "EffectFlags", "System", "SystemConfig", "lr_schedule"]
