"""Reference-mix generators (port of ``diffmst_tpu/mixing``)."""

from diffmst_torch.mixing.knowledge import (
    instrument_metadata,
    knowledge_engineering_mix,
    sample_ke_params,
)
from diffmst_torch.mixing.naive import NaiveRandomMix, naive_random_mix

__all__ = [
    "NaiveRandomMix",
    "naive_random_mix",
    "knowledge_engineering_mix",
    "sample_ke_params",
    "instrument_metadata",
]
