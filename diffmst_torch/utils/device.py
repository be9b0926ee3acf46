"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "use_full_float32"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA device. A CUDA device is refused, with an error,
    when no card is present: the port never drops to the CPU on its own — a
    caller that wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "diffmst_torch runs on the CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def use_full_float32() -> None:
    """Compute float32 in full float32: no TF32 in cuDNN's convolutions or
    in matrix products.

    The port's one precision, set by its CLI and by ``chip_smoke.py``: every
    kernel check, parity test and training reading of the port is taken at
    it. PyTorch's default lets cuDNN run float32 convolutions (most of a
    training step) in TF32, which would time a lower precision than the one
    those checks hold.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
