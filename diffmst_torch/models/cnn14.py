"""Cnn14 (PANN) spectrogram backbone.

Port of ``diffmst_tpu/models/cnn14.py``: six double-conv blocks (3x3 convs,
BatchNorm, ReLU, average pooling on the schedule below), a mean over
frequency, max + mean over time, and a linear head. Convolutions are NCHW
(the Flax model is NHWC).

BatchNorm follows Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, with
the ``train`` flag passed down every call as in the Flax model (the module's
``training`` attribute plays no part). With ``train=False`` it normalizes with
the running statistics. With ``train=True`` it normalizes with the batch's
mean and biased variance over every axis but the channels' (batch, bins,
frames here; batch and time in the FXencoder) and updates the running
statistics to 0.9 * running + 0.1 * batch, the variance biased too.
``F.batch_norm(training=True)`` would update running_var with the unbiased
variance, so the update is written out, under ``no_grad``.

``use_batchnorm=False`` drops the blocks' BatchNorm layers (the Flax
model's keyword of that name; a block is then conv -> ReLU).

Parameter names follow the reference (``conv_block1.conv1.weight``,
``conv_block1.bn1.running_mean``, ``fc.weight``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ConvBlock", "Cnn14", "batch_norm"]

BN_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch (diffmst_tpu/models/cnn14.py:47-54)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Flax's ``nn.BatchNorm(momentum=0.9)`` over the channel axis 1 of x,
    with ``bn``'s parameters and running statistics (see the module
    docstring)."""
    if not train:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps
        )
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, *range(2, x.ndim)), unbiased=False)
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
    # batch statistics, biased variance; running statistics left alone
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, use_batchnorm: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        if use_batchnorm:
            self.bn1 = nn.BatchNorm2d(out_channels, eps=1e-5)
            self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.use_batchnorm = use_batchnorm

    def _norm(self, i: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        return batch_norm(getattr(self, f"bn{i}"), x, train) if self.use_batchnorm else x

    def forward(self, x: torch.Tensor, pool_size, train: bool = False) -> torch.Tensor:
        """x: (bs, C, H, W)."""
        x = F.relu(self._norm(1, self.conv1(x), train))
        x = F.relu(self._norm(2, self.conv2(x), train))
        return F.avg_pool2d(x, pool_size)  # floors, as Flax VALID pooling does


class Cnn14(nn.Module):
    # pool schedule over (bins, frames), cnn14.py:98
    POOLS = ((2, 2), (4, 4), (4, 2), (4, 2), (4, 2), (2, 2))

    def __init__(
        self, num_classes: int, n_inputs: int = 1, base_width: int = 64, use_batchnorm: bool = True
    ):
        super().__init__()
        chans = [n_inputs] + [base_width << i for i in range(6)]
        for i in range(6):
            setattr(self, f"conv_block{i + 1}", ConvBlock(chans[i], chans[i + 1], use_batchnorm))
        self.fc = nn.Linear(chans[-1], num_classes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (bs, chs, bins, frames) spectrogram -> (bs, num_classes)."""
        if x.shape[2] < 1024 or x.shape[3] < 128:
            raise ValueError(
                f"Cnn14 needs a spectrogram of at least (1024 bins, 128 frames) "
                f"for its pool schedule; got {tuple(x.shape[2:4])}. Use n_fft >= 2048 "
                f"and seq_len >= 128 * hop_length."
            )
        for i, pool in enumerate(self.POOLS):
            x = getattr(self, f"conv_block{i + 1}")(x, pool, train)
        x = x.mean(dim=2)  # mean over frequency -> (bs, C, frames')
        x = x.amax(dim=2) + x.mean(dim=2)  # max + mean over time
        return self.fc(x)
