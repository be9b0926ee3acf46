"""TransformerController: console parameters from track and mix embeddings.

Port of ``diffmst_tpu/models/controller.py``: learned type embeddings added
to the track and mix tokens, learned fx-bus and master-bus tokens appended,
a post-norm transformer encoder over the num_tracks + 4 tokens, and sigmoid
heads for the three parameter groups. The padding mask is extended by the 4
always-attended tokens.

``dtype`` is the transformer's compute dtype; the tokens, the residual
stream and the three heads stay in the parameters' dtype, so the console
receives float32 parameters from a float32 model whatever the dtype (``diffmst_tpu/models/
controller.py:84-99``). ``use_fx_bus`` and ``use_master_bus`` are taken for
config parity and read nowhere, as in JAX and the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from diffmst_torch.models.transformer import TransformerEncoder

__all__ = ["TransformerController"]


class TransformerController(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_track_control_params: int,
        num_fx_bus_control_params: int,
        num_master_bus_control_params: int,
        num_layers: int = 6,
        nhead: int = 8,
        use_fx_bus: bool = False,
        use_master_bus: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        d = embed_dim
        self.track_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.mix_embedding = nn.Parameter(torch.empty(1, 2, d))
        self.fx_bus_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.master_bus_embedding = nn.Parameter(torch.empty(1, 1, d))
        self.transformer_encoder = TransformerEncoder(d, nhead, num_layers, dtype=dtype)
        self.track_projection = nn.Linear(d, num_track_control_params)
        self.fx_bus_projection = nn.Linear(d, num_fx_bus_control_params)
        self.master_bus_projection = nn.Linear(d, num_master_bus_control_params)

    def forward(
        self,
        track_embeds: torch.Tensor,
        mix_embeds: torch.Tensor,
        track_padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(bs, n, d) tracks, (bs, 2, d) mix channels, (bs, n) mask (True =
        padded) -> sigmoid-bounded (track (bs, n, P_t), fx (bs, P_f),
        master (bs, P_m)) parameters."""
        bs, n, d = track_embeds.shape
        seq = torch.cat(
            [
                track_embeds + self.track_embedding,
                mix_embeds + self.mix_embedding,
                self.fx_bus_embedding.expand(bs, 1, d),
                self.master_bus_embedding.expand(bs, 1, d),
            ],
            dim=1,
        )
        pad = None
        if track_padding_mask is not None:
            pad = torch.cat(
                [track_padding_mask, track_padding_mask.new_zeros(bs, 4)], dim=1
            )
        z = self.transformer_encoder(seq, key_padding_mask=pad)
        return (
            torch.sigmoid(self.track_projection(z[:, :n, :])),
            torch.sigmoid(self.fx_bus_projection(z[:, -2, :])),
            torch.sigmoid(self.master_bus_projection(z[:, -1, :])),
        )
