"""FXencoder: a 1-D convolutional audio-effects embedding; ParameterProjector:
linear heads from an embedding to the console's parameters.

Port of ``diffmst_tpu/models/fx_encoder.py`` (the reference's
``mst/fx_encoder.py`` and ``modules.py:557-591``). The FXencoder is a stack
of residual (or plain) conv blocks configured by a dict of channels,
kernels, strides and dilations, then a mean over time. Each conv pads by
reflection first, ``(k - 1) * dilation`` split ``pad // 2, pad - pad // 2``,
with NumPy's reflection (``ops.stft.reflect_pad``): the deep layers see a
few samples, fewer than the pad. BatchNorm is Flax's (``cnn14.batch_norm``).

Flax builds a conv's input width from what it is given; here ``n_inputs``
says it: 2 for stereo, 1 for the mono signals of parameter estimation.
Block 0's first conv then maps 1 channel to 2, and its residual adds the
mono input to both, as JAX's broadcast does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from diffmst_torch.models.cnn14 import batch_norm
from diffmst_torch.ops.stft import reflect_pad

__all__ = ["default_fx_encoder_config", "FXencoder", "ParameterProjector"]


def default_fx_encoder_config() -> Dict[str, Any]:
    """A FXencoder config of the upstream work's shape."""
    return {
        "channels": [16, 32, 64, 128, 256, 256, 512, 512, 1024, 1024, 2048, 2048],
        "kernels": [25, 25, 15, 15, 10, 10, 10, 10, 5, 5, 5, 5],
        "strides": [4, 4, 4, 4, 2, 2, 2, 2, 2, 2, 2, 2],
        "dilation": [1] * 12,
        "bias": True,
        "norm": "batch",
        "conv_block": "res",
        "activation": "relu",
    }


class _Conv1dLayer(nn.Module):
    """[reflection pad] -> conv -> [BatchNorm] -> [ReLU | leaky ReLU]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, same: bool = True, norm: str = "batch", activation: str = "relu"):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride, dilation=dilation)
        if norm == "batch":
            self.bn = nn.BatchNorm1d(out_channels, eps=1e-5, momentum=0.1)  # Flax momentum 0.9
        self.pad = (kernel_size - 1) * dilation if same else 0
        self.norm, self.activation = norm, activation

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.pad:
            x = reflect_pad(x, self.pad // 2, self.pad - self.pad // 2)
        x = self.conv(x)
        if self.norm == "batch":
            x = batch_norm(self.bn, x, train)
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "lrelu":
            x = nn.functional.leaky_relu(x, 0.01)
        return x


class _ResConvBlock(nn.Module):
    def __init__(self, n_inputs: int, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 dilation: int, norm: str, activation: str):
        super().__init__()
        self.conv1 = _Conv1dLayer(n_inputs, in_channels, kernel_size, 1, dilation, norm=norm, activation=activation)
        self.conv2 = _Conv1dLayer(in_channels, out_channels, kernel_size, stride, dilation, norm=norm,
                                  activation=activation)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv1(x, train) + x  # a mono x broadcasts over conv1's channels
        return self.conv2(x, train)


class FXencoder(nn.Module):
    """(bs, n_inputs, seq_len) audio -> (bs, channels[-1]) embedding."""

    def __init__(self, config: Dict[str, Any], n_inputs: int = 2):
        super().__init__()
        channels = list(config["channels"])
        if channels and channels[0] != 2:
            channels = [2] + channels  # the reference inserts the stereo input width
        # every conv has a bias: JAX's layers take the config's "bias" key nowhere
        norm, act = config.get("norm", "batch"), config.get("activation", "relu")
        blocks, width = [], n_inputs
        for i, k in enumerate(config["kernels"]):
            stride, dil = config["strides"][i], config["dilation"][i]
            if config.get("conv_block", "res") == "res":
                blocks.append(_ResConvBlock(width, channels[i], channels[i + 1], k, stride, dil, norm, act))
            else:
                blocks.append(_Conv1dLayer(width, channels[i + 1], k, stride, dil, same=False, norm=norm,
                                           activation=act))
            width = channels[i + 1]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, train)
        return x.mean(dim=-1)  # global average pool over time


class ParameterProjector(nn.Module):
    """Embedding -> sigmoid console parameters (track (bs, num_tracks, P_t),
    fx bus (bs, P_f), master bus (bs, P_m)).

    ``embed_dim`` is the width of what reaches the heads. In parameter
    estimation that is twice the encoder's embedding (the left and the
    right channel's differences); JAX's Dense layers take it from the input
    and leave the field unused."""

    def __init__(self, embed_dim: int, num_tracks: int, num_track_control_params: int,
                 num_fx_bus_control_params: int, num_master_bus_control_params: int):
        super().__init__()
        self.num_tracks = num_tracks
        self.track_projector = nn.Linear(embed_dim, num_tracks * num_track_control_params)
        self.fx_bus_projector = nn.Linear(embed_dim, num_fx_bus_control_params)
        self.master_bus_projector = nn.Linear(embed_dim, num_master_bus_control_params)

    def forward(self, z: torch.Tensor):
        track = torch.sigmoid(self.track_projector(z)).reshape(z.shape[0], self.num_tracks, -1)
        return track, torch.sigmoid(self.fx_bus_projector(z)), torch.sigmoid(self.master_bus_projector(z))
