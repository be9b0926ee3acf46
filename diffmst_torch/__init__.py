"""diffmst_torch — Differentiable Mixing Style Transfer in PyTorch and CUDA.

The PyTorch port of ``diffmst_tpu``, laid out like it so every module has a
counterpart of the same name: ``ops`` (DSP primitives), ``kernels``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version), ``console`` (the mix consoles), ``models`` (Cnn14 encoders and the
transformer controller), ``train`` (the System and the Trainer), ``data``
(the host data pipeline), ``callbacks`` (the CSV log) and ``utils``
(inference, checkpoints, the config registry).

The package imports torch, numpy, scipy and yaml only. Its entry points
(``utils.inference.run_diffmst``, ``models.MixStyleTransferModel.build``,
the consoles, ``main_torch.py`` at the repository root) run on the CUDA
device unless the caller passes ``device="cpu"``; see
``utils.device.resolve_device``.
"""

__version__ = "0.1.0"
