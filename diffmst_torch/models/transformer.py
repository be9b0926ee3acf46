"""Post-norm transformer encoder with torch.nn.TransformerEncoderLayer's names.

Port of ``diffmst_tpu/models/transformer.py``: post-layer-norm, ReLU
feed-forward of width 2048, dropout 0, biased projections, and an additive
-1e9 bias on padded keys. The layer is written out rather than taken from
``nn.TransformerEncoderLayer`` so the mask is the JAX package's additive bias
and no inference fast path changes the numbers; its state-dict names are
``nn.TransformerEncoderLayer``'s (``self_attn.in_proj_weight``, ...), so a
reference checkpoint loads as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffmst_torch.models.cnn14 import cast_to

__all__ = ["TransformerEncoderLayer", "TransformerEncoder"]

_NEG_INF = -1e9


class _SelfAttention(nn.Module):
    """Holds nn.MultiheadAttention's parameter names: in_proj_weight (3d, d),
    in_proj_bias (3d,), out_proj."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nhead = nhead
        self.dtype = dtype
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """x: (bs, seq, d_model); key_padding_mask: (bs, seq), True = ignore."""
        bs, seq, d = x.shape
        h = self.nhead
        hd = d // h
        dt = self.dtype

        def dense(weight, bias, t):
            return F.linear(cast_to(t, dt), cast_to(weight, dt), cast_to(bias, dt))

        attn = self.self_attn
        qkv = dense(attn.in_proj_weight, attn.in_proj_bias, x)
        q, k, v = (t.reshape(bs, seq, h, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)).to(x.dtype) / math.sqrt(hd)
        if key_padding_mask is not None:
            bias = torch.where(key_padding_mask[:, None, None, :], _NEG_INF, 0.0)
            scores = scores + bias.to(scores.dtype)
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v.to(x.dtype))
        ctx = dense(attn.out_proj.weight, attn.out_proj.bias, ctx.transpose(1, 2).reshape(bs, seq, d))
        x = self.norm1(x + ctx.to(x.dtype))  # post-norm residual blocks
        ff = F.relu(dense(self.linear1.weight, self.linear1.bias, x))
        ff = dense(self.linear2.weight, self.linear2.bias, ff)
        return self.norm2(x + ff.to(x.dtype))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 2048,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dtype) for _ in range(num_layers)
        )

    def forward(
        self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x
