"""Carry weights from the Flax MixStyleTransferModel into the port.

``state_dict_from_flax`` is the inverse of ``diffmst_tpu/utils/checkpoint.py
::port_torch_state_dict``: Flax conv kernels HWIO -> OIHW, Dense kernels
transposed, q/k/v stacked into ``in_proj_weight``/``in_proj_bias``, BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var, the four learned
tokens as they are. The port keeps its own copy of the mapping.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _cnn14(params: Dict, stats: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    for block, p in params.items():
        if not re.fullmatch(r"conv_block\d", block):
            continue
        for i in (1, 2):
            sd[f"{prefix}{block}.conv{i}.weight"] = _t(
                np.asarray(p[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
            )
            bn, st = p[f"bn{i}"], stats[block][f"bn{i}"]
            sd[f"{prefix}{block}.bn{i}.weight"] = _t(bn["scale"])
            sd[f"{prefix}{block}.bn{i}.bias"] = _t(bn["bias"])
            sd[f"{prefix}{block}.bn{i}.running_mean"] = _t(st["mean"])
            sd[f"{prefix}{block}.bn{i}.running_var"] = _t(st["var"])
            sd[f"{prefix}{block}.bn{i}.num_batches_tracked"] = torch.tensor(0)
    sd[f"{prefix}fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd[f"{prefix}fc.bias"] = _t(params["fc"]["bias"])


def _dense(p: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of the Flax MixStyleTransferModel (nested
    dicts of arrays) -> the port's ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for enc in ("track_encoder", "mix_encoder"):
        _cnn14(params[enc]["model"], stats[enc]["model"], f"{enc}.model.", sd)

    ctrl = params["controller"]
    for tok in ("track_embedding", "mix_embedding", "fx_bus_embedding", "master_bus_embedding"):
        sd[f"controller.{tok}"] = _t(ctrl[tok])
    layers = sorted(
        int(k.split("_")[1]) for k in ctrl["transformer_encoder"] if k.startswith("layers_")
    )
    for i in layers:
        lp = ctrl["transformer_encoder"][f"layers_{i}"]
        pre = f"controller.transformer_encoder.layers.{i}"
        qkv = ("q_proj", "k_proj", "v_proj")
        sd[f"{pre}.self_attn.in_proj_weight"] = _t(
            np.concatenate([np.asarray(lp[n]["kernel"]).T for n in qkv], axis=0)
        )
        sd[f"{pre}.self_attn.in_proj_bias"] = _t(
            np.concatenate([np.asarray(lp[n]["bias"]) for n in qkv], axis=0)
        )
        _dense(lp["out_proj"], f"{pre}.self_attn.out_proj", sd)
        _dense(lp["linear1"], f"{pre}.linear1", sd)
        _dense(lp["linear2"], f"{pre}.linear2", sd)
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = _t(lp[norm]["scale"])
            sd[f"{pre}.{norm}.bias"] = _t(lp[norm]["bias"])
    for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
        _dense(ctrl[head], f"controller.{head}", sd)
    return sd
