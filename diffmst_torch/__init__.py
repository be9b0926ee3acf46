"""diffmst_torch — Differentiable Mixing Style Transfer in PyTorch and CUDA.

The PyTorch port of ``diffmst_tpu``, laid out like it so every module has a
counterpart of the same name: ``ops`` (DSP primitives), ``kernels``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version), ``console`` (the mix consoles), ``models`` (Cnn14 encoders and the
transformer controller) and ``utils`` (inference, weight conversion).

The package imports torch, numpy and scipy only. Its entry points
(``utils.inference.run_diffmst``, ``models.MixStyleTransferModel.build``,
the consoles) run on the CUDA device unless the caller passes
``device="cpu"``; see ``utils.device.resolve_device``.
"""

__version__ = "0.1.0"
