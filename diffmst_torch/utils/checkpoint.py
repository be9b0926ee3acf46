"""Checkpoints of a training run, and weights from the reference and from Flax.

  * ``save_state`` / ``restore_state`` / ``load_meta``: the port's
    counterparts of ``diffmst_tpu/utils/checkpoint.py``'s orbax functions. A
    checkpoint is one ``torch.save`` file of ``System.state_dict()`` with every
    tensor copied to the host, so it loads on any device; beside it,
    ``<path>.meta.json`` holds the training progress (the Trainer's
    ``next_epoch``, ``step`` and ``steps_per_epoch``).
  * ``load_reference_checkpoint``: a reference Lightning ``.ckpt``'s
    ``model.*`` tensors into the port's model, whose state-dict names are the
    reference's (the counterpart of ``port_torch_checkpoint``).
  * ``state_dict_from_flax``: the inverse of ``port_torch_state_dict``:
    Flax conv kernels HWIO -> OIHW, Dense kernels transposed, q/k/v stacked
    into ``in_proj_weight``/``in_proj_bias``, BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var, the four learned tokens as they are.
    The port keeps its own copy of the mapping; it reads every shape from
    the arrays, so Cnn14 at any width (``cnn_min_width``) carries across.
    ``waveform_encoder_state_dict_from_flax`` carries a
    ``WaveformTransformerEncoder``. Its siblings carry the
    parameter-estimation models across: ``fx_encoder_state_dict_from_flax``,
    ``projector_state_dict_from_flax``, ``unet_state_dict_from_flax`` and
    ``param_est_state_dict_from_flax`` (JAX's ``{"encoder", "projector"}``).
  * ``port_hdemucs_state_dict`` / ``load_hdemucs_checkpoint``: a torchaudio
    HDemucs state dict (or weights file) into ``models.HDemucs``, strictly;
    a dict without one of HDemucs's four layer lists raises.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "save_state",
    "restore_state",
    "restore_model",
    "load_meta",
    "load_reference_checkpoint",
    "state_dict_from_flax",
    "encoder_state_dict",
    "waveform_encoder_state_dict_from_flax",
    "fx_encoder_state_dict_from_flax",
    "projector_state_dict_from_flax",
    "unet_state_dict_from_flax",
    "param_est_state_dict_from_flax",
    "port_hdemucs_state_dict",
    "load_hdemucs_checkpoint",
]


def _to_host(obj: Any) -> Any:
    """A copy of a nest of dicts, lists and tuples with each tensor on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save_state(path: str, system, meta: Dict[str, Any] = None) -> int:
    """Write ``system.state_dict()`` to ``path`` and ``meta`` to
    ``<path>.meta.json``; return the checkpoint's bytes.

    Tensors reach the host one at a time, so no second copy of the model or
    the optimizer state is made on the card. The file is written beside
    ``path`` and renamed onto it, so an interrupted save leaves the previous
    checkpoint whole.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_host(system.state_dict()), tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    return os.path.getsize(path)


def restore_state(path: str, system) -> None:
    """Load a ``save_state`` checkpoint into ``system`` in place."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True, mmap=True)
    system.load_state_dict(state)


def restore_model(path: str, model: torch.nn.Module) -> None:
    """Load only the model's weights and BatchNorm statistics of a
    ``save_state`` checkpoint (for inference)."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True, mmap=True)
    model.load_state_dict(state["model"])


def load_meta(path: str) -> Dict[str, Any]:
    """The ``save_state`` meta sidecar, or {} where there is none."""
    p = os.path.abspath(path) + ".meta.json"
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """Load a reference Lightning checkpoint's ``model.*`` tensors into a
    ``MixStyleTransferModel`` in place (the prefix split of the reference's
    ``mst/utils.py::load_diffmst``). Every tensor of the model must be in the
    checkpoint; the checkpoint's other entries are left out, as
    ``port_torch_checkpoint`` leaves them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k[len("model."):]: v for k, v in ckpt["state_dict"].items() if k.startswith("model.")}
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{path}: the checkpoint lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in own if k in sd}, strict=False)


def _t(a) -> torch.Tensor:
    """float64 values stay float64 (a float64 reference carried exactly),
    any other become float32."""
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == np.float64 else a.astype(np.float32))


def _cnn14(params: Dict, stats: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    for block, p in params.items():
        if not re.fullmatch(r"conv_block\d", block):
            continue
        for i in (1, 2):
            sd[f"{prefix}{block}.conv{i}.weight"] = _t(
                np.asarray(p[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
            )
            if f"bn{i}" in p:  # absent with encoder_batchnorm=False
                _batchnorm(p[f"bn{i}"], stats[block][f"bn{i}"], f"{prefix}{block}.bn{i}", sd)
    sd[f"{prefix}fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
    sd[f"{prefix}fc.bias"] = _t(params["fc"]["bias"])


def _batchnorm(p: Dict, st: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(st["mean"])
    sd[f"{prefix}.running_var"] = _t(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def encoder_state_dict(params: Dict, stats: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    """A Flax SpectrogramEncoder's variables (its input BatchNorm ``bn``,
    when it has one, and its Cnn14 ``model``) into ``sd`` under ``prefix``."""
    if "bn" in params:
        _batchnorm(params["bn"], stats["bn"], f"{prefix}bn", sd)
    _cnn14(params["model"], stats.get("model", {}), f"{prefix}model.", sd)


def _dense(p: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of the Flax MixStyleTransferModel (nested
    dicts of arrays) -> the port's ``state_dict``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for enc in ("track_encoder", "mix_encoder"):
        if "cls" in params[enc]:  # a WaveformTransformerEncoder
            sd.update((f"{enc}.{k}", v) for k, v in waveform_encoder_state_dict_from_flax(params[enc]).items())
        else:
            encoder_state_dict(params[enc], stats.get(enc, {}), f"{enc}.", sd)

    ctrl = params["controller"]
    for tok in ("track_embedding", "mix_embedding", "fx_bus_embedding", "master_bus_embedding"):
        sd[f"controller.{tok}"] = _t(ctrl[tok])
    _transformer(ctrl["transformer_encoder"], "controller.transformer_encoder", sd)
    for head in ("track_projection", "fx_bus_projection", "master_bus_projection"):
        _dense(ctrl[head], f"controller.{head}", sd)
    return sd


def _transformer(params: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    """A Flax TransformerEncoder's ``layers_i`` into ``sd`` under ``prefix``."""
    layers = sorted(int(k.split("_")[1]) for k in params if k.startswith("layers_"))
    for i in layers:
        lp = params[f"layers_{i}"]
        pre = f"{prefix}.layers.{i}"
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


def waveform_encoder_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """A Flax ``WaveformTransformerEncoder``'s params (``cls`` and the
    transformer ``model``) -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {"cls": _t(params["cls"])}
    _transformer(params["model"], "model", sd)
    return sd


def _fx_layer(p: Dict, st: Dict, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    sd[f"{prefix}.conv.weight"] = _t(np.asarray(p["Conv_0"]["kernel"]).transpose(2, 1, 0))  # (k, in, out) -> OIK
    sd[f"{prefix}.conv.bias"] = _t(p["Conv_0"]["bias"])
    if "BatchNorm_0" in p:
        _batchnorm(p["BatchNorm_0"], st["BatchNorm_0"], f"{prefix}.bn", sd)


def fx_encoder_state_dict_from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A Flax ``FXencoder``'s variables -> the port's ``FXencoder`` state dict
    (``block{i}`` -> ``blocks.{i}``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in sorted(int(k[len("block"):]) for k in params):
        p, st = params[f"block{i}"], batch_stats.get(f"block{i}", {})
        if "conv1" in p:  # a residual block
            for c in ("conv1", "conv2"):
                _fx_layer(p[c], st.get(c, {}), f"blocks.{i}.{c}", sd)
        else:
            _fx_layer(p, st, f"blocks.{i}", sd)
    return sd


def projector_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """A Flax ``ParameterProjector``'s params -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for head in ("track_projector", "fx_bus_projector", "master_bus_projector"):
        _dense(params[head], head, sd)
    return sd


def unet_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """A Flax ``UNetSeparator``'s params -> the port's state dict: ``Conv_i``
    HWIO -> ``convs.i`` OIHW; ``ConvTranspose_i`` (Flax correlates the
    dilated input with its HWIO kernel) -> ``deconvs.i``, torch's (in, out,
    kH, kW) flipped in space, since ``conv_transpose2d`` correlates with the
    flipped kernel."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        kind, i = name.rsplit("_", 1)
        kernel = np.asarray(p["kernel"])
        if kind == "Conv":
            sd[f"convs.{i}.weight"] = _t(kernel.transpose(3, 2, 0, 1))
            sd[f"convs.{i}.bias"] = _t(p["bias"])
        elif kind == "ConvTranspose":
            sd[f"deconvs.{i}.weight"] = _t(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]))
            sd[f"deconvs.{i}.bias"] = _t(p["bias"])
        else:
            raise KeyError(f"unexpected UNetSeparator parameter {name!r}")
    return sd


def param_est_state_dict_from_flax(params: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX's parameter-estimation variables ``{"encoder": {"params",
    "batch_stats"}, "projector": {"params"}}`` (``ParamTrainState.params``)
    -> ``{"encoder": ..., "projector": ...}`` state dicts of the port's
    encoder (a ``SpectrogramEncoder`` or an ``FXencoder``) and projector."""
    enc = params["encoder"]
    p, st = enc["params"], enc.get("batch_stats", {}) or {}
    if "model" in p:
        encoder: Dict[str, torch.Tensor] = {}
        encoder_state_dict(p, st, "", encoder)
    else:
        encoder = fx_encoder_state_dict_from_flax(p, st)
    return {"encoder": encoder, "projector": projector_state_dict_from_flax(params["projector"]["params"])}


_HDEMUCS_SECTIONS = ("encoder", "decoder", "tencoder", "tdecoder")


def port_hdemucs_state_dict(state_dict: Dict[str, Any], model: torch.nn.Module = None) -> Dict[str, torch.Tensor]:
    """A torchaudio HDemucs ``state_dict`` (tensors or arrays) -> tensors in
    torch's layout, which ``models.HDemucs`` takes as they are, loaded into
    ``model`` with ``strict=True`` when one is given.

    Each of ``encoder``, ``decoder``, ``tencoder`` and ``tdecoder`` must be
    there with layer indices 0, 1, ..., n - 1: a checkpoint of another
    architecture raises instead of separating garbage, as JAX's converter
    does."""
    for section in _HDEMUCS_SECTIONS:
        idx = {int(k.split(".")[1]) for k in state_dict if k.startswith(section + ".")}
        if not idx or idx != set(range(len(idx))):
            raise ValueError(f"state_dict missing HDemucs section {section!r} — not an HDemucs checkpoint?")
    sd = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()}
    if model is not None:
        model.load_state_dict(sd, strict=True)
    return sd


def load_hdemucs_checkpoint(path: str, model: torch.nn.Module = None, **hdemucs_kwargs) -> torch.nn.Module:
    """Load an HDemucs weights file (a raw state dict, or a dict with a
    ``state_dict`` entry) strictly into ``model``, or into a new
    ``HDemucs(**hdemucs_kwargs)`` on the host; returns the model."""
    from diffmst_torch.models.hdemucs import HDemucs

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    model = HDemucs(**hdemucs_kwargs) if model is None else model
    port_hdemucs_state_dict(sd, model)
    return model
