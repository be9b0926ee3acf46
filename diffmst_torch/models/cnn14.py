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

Across a device mesh (``diffmst_torch/parallel``), a train-mode BatchNorm
takes the statistics of every rank's batch, as Flax's ``axis_name`` does
(``diffmst_tpu/models/cnn14.py:29, :51``): over the dp axis always (JAX's
jitted step sees the global batch) and over the axes ``bn_axis_name`` names
(``("dp", "mp")``: the whole mesh, for the track-parallel System). The
statistics come from the all-reduced per-channel sum and count, then the
all-reduced sum of squared deviations from the shared mean (two passes), in
float32 for a float32 or bf16 input and in float64 for a float64 one; the
variance is biased and the running statistics move as above. The
backward pass all-reduces the two sums of the cotangents the statistics
take, as a synchronized BatchNorm's does. ``torch.nn.SyncBatchNorm`` is not
used: it keeps the unbiased variance in its running statistics.

The JAX package's compute options (``cnn14.py:29-30, :71-95``):

  * ``dtype`` (None: the parameters' dtype): the input is cast to it, the
    convolutions and ``fc`` run in it on weights cast from their float32
    copies, and the output is cast to float32, as Flax's ``dtype=bf16``
    does. BatchNorm takes its statistics in float32 and keeps its running
    statistics and parameters in float32; only its output is rounded to the
    dtype.
  * ``min_width``: every block is ``max(base_width << i, min_width)`` wide.
  * ``remat_blocks``: the first N blocks are recomputed in the backward
    pass (``torch.utils.checkpoint``, non-reentrant). The recomputed forward
    leaves the running statistics alone (``recompute_context``), so a step
    updates them once, as Flax's functional ``nn.remat`` does.

Parameter names follow the reference (``conv_block1.conv1.weight``,
``conv_block1.bn1.running_mean``, ``fc.weight``, ...).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffmst_torch.parallel.mesh import bn_group

__all__ = ["ConvBlock", "Cnn14", "batch_norm", "rematerialized", "cast_to"]

BN_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch (diffmst_tpu/models/cnn14.py:47-54)

_recomputing = threading.local()


@contextlib.contextmanager
def _recompute():
    """Marks the thread as recomputing a checkpointed forward."""
    _recomputing.active = True
    try:
        yield
    finally:
        _recomputing.active = False


def recompute_context():
    """``checkpoint``'s ``context_fn``: nothing around the first forward, the
    recompute flag around the backward's recomputation."""
    return contextlib.nullcontext(), _recompute()


def rematerialized(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    autograd records the call (``torch.utils.checkpoint``, non-reentrant)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=recompute_context)


def cast_to(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    """``t`` in the compute dtype (None: as it is)."""
    return t if t is None or dtype is None else t.to(dtype)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, train: bool, axis_name=None) -> torch.Tensor:
    """Flax's ``nn.BatchNorm(momentum=0.9)`` over the channel axis 1 of x,
    with ``bn``'s parameters and running statistics (see the module
    docstring). A bfloat16 or float16 x is normalized in float32 and the
    result rounded to x's dtype. In training under a bound mesh the
    statistics are those of every rank along ``axis_name`` and dp."""
    if not train:
        return F.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps
        )
    group = bn_group(axis_name)
    if group is not None:
        mean, var, y = _GroupBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, group)
        if not getattr(_recomputing, "active", False):
            _update_running(bn, mean, var)
        return y
    if not getattr(_recomputing, "active", False):
        with torch.no_grad():
            wide = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(wide, dim=(0, *range(2, x.ndim)), unbiased=False)
            _update_running(bn, mean, var)
    # batch statistics, biased variance; running statistics left alone
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


@torch.no_grad()
def _update_running(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
    bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm on the statistics of a process group's batches:
    (mean, biased variance, y). Forward: two passes, as the local path's
    ``var_mean`` takes them: an all-reduce of the per-channel (sum, count),
    then one of the sums of (x - mean)^2 (a one-pass E[x^2] - mean^2 loses
    float32's digits where |mean| is far above the spread, as on magnitude
    spectrograms). Backward: one all-reduce of the per-channel sums of dy
    and of dy * (x - mean), which every rank's outputs hand the shared
    statistics; dx from them, and the weight's and bias's gradients from
    this rank's elements alone (the System sums those over the ranks with
    the other gradients)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        wide = torch.promote_types(x.dtype, torch.float32)
        dims = (0, *range(2, x.ndim))
        c = x.shape[1]
        shape = (1, c) + (1,) * (x.ndim - 2)
        xw = x.to(wide)
        stats = torch.cat([xw.sum(dims), xw.new_full((1,), x.numel() // c)])
        dist.all_reduce(stats, group=group)
        count = stats[c]
        mean = stats[:c] / count
        xmu = xw - mean.view(shape)
        var = xmu.square().sum(dims)
        dist.all_reduce(var, group=group)
        var = var / count
        invstd = torch.rsqrt(var + eps)
        scale = (invstd * weight.to(wide)).view(shape)
        y = (xmu * scale + bias.to(wide).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return mean, var, y

    @staticmethod
    def backward(ctx, _dmean, _dvar, dy):
        x, weight, mean, invstd, count = ctx.saved_tensors
        wide = mean.dtype
        dims = (0, *range(2, x.ndim))
        c = x.shape[1]
        shape = (1, c) + (1,) * (x.ndim - 2)
        xmu = x.to(wide) - mean.view(shape)
        dyw = dy.to(wide)
        local = torch.cat([dyw.sum(dims), (dyw * xmu).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy = (sums[:c] / count).view(shape)
        mean_dy_xmu = (sums[c:] / count).view(shape)
        inv = invstd.view(shape)
        dx = (dyw - mean_dy - xmu * (inv * inv) * mean_dy_xmu) * (inv * weight.to(wide).view(shape))
        dweight = (local[c:] * invstd).to(weight.dtype)
        dbias = local[:c].to(weight.dtype)
        return dx.to(x.dtype), dweight, dbias, None, None


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, use_batchnorm: bool = True,
                 dtype: Optional[torch.dtype] = None, bn_axis_name=None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        if use_batchnorm:
            self.bn1 = nn.BatchNorm2d(out_channels, eps=1e-5)
            self.bn2 = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.use_batchnorm = use_batchnorm
        self.dtype = dtype
        self.bn_axis_name = bn_axis_name

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv{i}")
        return F.conv2d(x, cast_to(conv.weight, self.dtype), padding=1)

    def _norm(self, i: int, x: torch.Tensor, train: bool) -> torch.Tensor:
        return batch_norm(getattr(self, f"bn{i}"), x, train, self.bn_axis_name) if self.use_batchnorm else x

    def forward(self, x: torch.Tensor, pool_size, train: bool = False) -> torch.Tensor:
        """x: (bs, C, H, W)."""
        x = F.relu(self._norm(1, self._conv(1, x), train))
        x = F.relu(self._norm(2, self._conv(2, x), train))
        return F.avg_pool2d(x, pool_size)  # floors, as Flax VALID pooling does


class Cnn14(nn.Module):
    # pool schedule over (bins, frames), cnn14.py:98
    POOLS = ((2, 2), (4, 4), (4, 2), (4, 2), (4, 2), (2, 2))

    def __init__(
        self, num_classes: int, n_inputs: int = 1, base_width: int = 64, use_batchnorm: bool = True,
        dtype: Optional[torch.dtype] = None, min_width: int = 0, remat_blocks: int = 0,
        bn_axis_name=None,
    ):
        super().__init__()
        chans = [n_inputs] + [max(base_width << i, min_width) for i in range(6)]
        for i in range(6):
            setattr(self, f"conv_block{i + 1}",
                    ConvBlock(chans[i], chans[i + 1], use_batchnorm, dtype, bn_axis_name))
        self.fc = nn.Linear(chans[-1], num_classes)
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        self.bn_axis_name = bn_axis_name

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: (bs, chs, bins, frames) spectrogram -> (bs, num_classes)."""
        if x.shape[2] < 1024 or x.shape[3] < 128:
            raise ValueError(
                f"Cnn14 needs a spectrogram of at least (1024 bins, 128 frames) "
                f"for its pool schedule; got {tuple(x.shape[2:4])}. Use n_fft >= 2048 "
                f"and seq_len >= 128 * hop_length."
            )
        x = cast_to(x, self.dtype)
        for i, pool in enumerate(self.POOLS):
            block = getattr(self, f"conv_block{i + 1}")
            if i < self.remat_blocks:
                x = rematerialized(block, x, pool, train)
            else:
                x = block(x, pool, train)
        x = x.mean(dim=2)  # mean over frequency -> (bs, C, frames')
        x = x.amax(dim=2) + x.mean(dim=2)  # max + mean over time
        x = F.linear(x, cast_to(self.fc.weight, self.dtype), cast_to(self.fc.bias, self.dtype))
        return x if self.dtype is None else x.float()
