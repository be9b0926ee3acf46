"""Utilities: device selection, inference, weight conversion.

Import the submodules directly (``diffmst_torch.utils.inference``, ...).
"""
