"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

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
