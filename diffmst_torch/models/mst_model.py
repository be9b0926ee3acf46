"""MixStyleTransferModel: the parameter-prediction network.

Port of ``diffmst_tpu/models/mst_model.py``: each mono track and each
reference-mix channel goes through its own spectrogram encoder, and the
controller maps the embeddings to console parameters. Module names are the
reference's, so its state-dict keys are ``track_encoder.model.conv_block1
.conv1.weight``, ``controller.transformer_encoder.layers.0.self_attn
.in_proj_weight``, ... (a reference checkpoint loads after stripping its
``model.`` prefix).

``build`` takes the JAX package's compute options (``diffmst_tpu/models/
mst_model.py:92-166``): ``compute_dtype`` (the encoders' Cnn14 and the
controller's transformer compute in it; the parameters, the BatchNorm
statistics, the heads and the outputs stay float32), ``remat_encoders``
(each encoder recomputed whole in the backward pass), ``remat_blocks``
(only the first N Cnn14 blocks), ``cnn_min_width`` and ``crop_nyquist_bin``.
``bn_axis_name`` (BatchNorm statistics across a device mesh) waits for the
mesh (ROADMAP Queue 1, item 12e).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from diffmst_torch.models.cnn14 import Cnn14
from diffmst_torch.models.controller import TransformerController
from diffmst_torch.models.encoders import SpectrogramEncoder, WaveformTransformerEncoder
from diffmst_torch.models.transformer import _SelfAttention
from diffmst_torch.utils.config import NotPortedError
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["MixStyleTransferModel"]


class MixStyleTransferModel(nn.Module):
    def __init__(
        self,
        track_encoder: nn.Module,
        mix_encoder: nn.Module,
        controller: TransformerController,
        sum_and_diff: bool = False,
    ):
        super().__init__()
        self.track_encoder = track_encoder
        self.mix_encoder = mix_encoder
        self.controller = controller
        self.sum_and_diff = sum_and_diff

    def encode_tracks(self, tracks: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(bs, num_tracks, seq_len) -> (bs, num_tracks, embed_dim). Every
        track, padded ones included, enters the BatchNorm statistics, as in
        the Flax model."""
        bs, num_tracks, seq_len = tracks.shape
        e = self.track_encoder(tracks.reshape(bs * num_tracks, 1, seq_len), train)
        return e.reshape(bs, num_tracks, -1)

    def encode_mix(self, ref_mix: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(bs, 2, seq_len) -> (bs, 2, embed_dim); mid/side with sum_and_diff."""
        if self.sum_and_diff:
            mid = ref_mix[:, 0:1, :] + ref_mix[:, 1:2, :]
            side = ref_mix[:, 0:1, :] - ref_mix[:, 1:2, :]
            return torch.stack([self.mix_encoder(mid, train), self.mix_encoder(side, train)], dim=1)
        bs = ref_mix.shape[0]
        e = self.mix_encoder(ref_mix.reshape(bs * 2, 1, ref_mix.shape[-1]), train)
        return e.reshape(bs, 2, -1)

    def forward(
        self,
        tracks: torch.Tensor,
        ref_mix: torch.Tensor,
        track_padding_mask: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(bs, num_tracks, T) stems, (bs, 2, T) reference -> (track_params,
        fx_bus_params, master_bus_params), all in (0, 1). ``train=True``
        runs BatchNorm on batch statistics and updates its running ones, as
        the Flax model's ``train`` (diffmst_tpu/models/mst_model.py:64-89)."""
        return self.controller(
            self.encode_tracks(tracks, train), self.encode_mix(ref_mix, train), track_padding_mask
        )

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MixStyleTransferModel":
        """(Re)initialize every parameter and buffer in place, drawing from a
        CPU ``generator`` so the weights do not depend on the device.

        The Flax model's initializers: Xavier-uniform convolutions and Cnn14
        heads, LeCun-normal (truncated) transformer and head matrices, zero
        biases, unit norms, N(0, 1) tokens (and a waveform encoder's CLS
        block), zero-mean unit-variance BatchNorm statistics.
        """

        def fill(t: torch.Tensor, draw) -> None:
            cpu = torch.empty(t.shape, dtype=t.dtype)
            draw(cpu)
            t.copy_(cpu)

        def xavier(t):
            fill(t, lambda c: nn.init.xavier_uniform_(c, generator=generator))

        def lecun(t):
            # Flax's lecun_normal: truncated at 2 std, std corrected for the cut
            std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
            fill(t, lambda c: nn.init.trunc_normal_(c, 0.0, std, -2 * std, 2 * std, generator=generator))

        cnn_heads = {id(m.fc) for m in self.modules() if isinstance(m, Cnn14)}
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier(m.weight)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                (xavier if id(m) in cnn_heads else lecun)(m.weight)
                m.bias.zero_()
            elif isinstance(m, _SelfAttention):
                for i in range(3):  # q, k and v: each (d, d) with fan-in d
                    d = m.in_proj_weight.shape[1]
                    lecun(m.in_proj_weight[i * d : (i + 1) * d])
                m.in_proj_bias.zero_()
            elif isinstance(m, TransformerController):
                for tok in (m.track_embedding, m.mix_embedding, m.fx_bus_embedding,
                            m.master_bus_embedding):
                    fill(tok, lambda c: c.normal_(generator=generator))
            elif isinstance(m, WaveformTransformerEncoder):
                fill(m.cls, lambda c: c.normal_(generator=generator))
        return self

    @staticmethod
    def build(
        embed_dim: int = 512,
        n_fft: int = 2048,
        hop_length: int = 512,
        num_layers: int = 12,
        nhead: int = 8,
        num_track_control_params: int = 27,
        num_fx_bus_control_params: int = 25,
        num_master_bus_control_params: int = 26,
        sum_and_diff: bool = False,
        cnn_base_width: int = 64,
        cnn_min_width: int = 0,
        crop_nyquist_bin: bool = False,
        compute_dtype: Optional[Union[str, torch.dtype]] = None,
        remat_encoders: bool = False,
        remat_blocks: int = 0,
        bn_axis_name: Optional[str] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> "MixStyleTransferModel":
        """The shipped configuration (configs/models/naive.yaml), in eval
        mode on ``device`` (None: the CUDA device), initialized from
        ``generator`` (default: a CPU generator seeded 0). On the ``"meta"``
        device it is returned uninitialized, for a caller that allocates
        and initializes it (``main_torch.py``). ``compute_dtype`` is a dtype
        or its name (``"bfloat16"``); the compute options are described in
        the module docstring."""
        if bn_axis_name is not None:
            raise NotPortedError(
                "bn_axis_name (BatchNorm statistics across a device mesh) is not ported to "
                "diffmst_torch yet: ROADMAP Queue 1, item 12e"
            )
        if remat_encoders and remat_blocks:
            raise ValueError("use either remat_encoders or remat_blocks")
        dtype = getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype
        dev = resolve_device(device)

        def encoder():
            return SpectrogramEncoder(
                embed_dim=embed_dim, n_fft=n_fft, hop_length=hop_length,
                cnn_base_width=cnn_base_width, cnn_min_width=cnn_min_width,
                crop_nyquist=crop_nyquist_bin, dtype=dtype, remat_blocks=remat_blocks,
                remat=remat_encoders,
            )

        with torch.device("meta"):  # allocate once, on the target device
            model = MixStyleTransferModel(
                track_encoder=encoder(),
                mix_encoder=encoder(),
                controller=TransformerController(
                    embed_dim=embed_dim,
                    num_track_control_params=num_track_control_params,
                    num_fx_bus_control_params=num_fx_bus_control_params,
                    num_master_bus_control_params=num_master_bus_control_params,
                    num_layers=num_layers,
                    nhead=nhead,
                    dtype=dtype,
                ),
                sum_and_diff=sum_and_diff,
            )
        if dev.type == "meta":
            return model
        model = model.to_empty(device=dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return model.init(generator).eval()
