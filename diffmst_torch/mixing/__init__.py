"""Reference-mix generators (port of ``diffmst_tpu/mixing``)."""

from diffmst_torch.mixing.naive import NaiveRandomMix, naive_random_mix

__all__ = ["NaiveRandomMix", "naive_random_mix"]
