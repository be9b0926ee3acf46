"""class_path config registry: the YAML surface of LightningCLI.

Port of ``diffmst_tpu/utils/config.py``. ``instantiate`` builds objects from
``{class_path: pkg.Cls, init_args: {...}}`` nodes, nested nodes first;
``load_config`` overlays ``-c`` files left to right, later files
deep-merging over earlier ones (a node whose class the later file changes
is replaced, not merged: ``deep_merge``). Class paths of the reference (``mst.*``,
``auraloss.freq.MultiResolutionSTFTLoss``) and of the JAX package
(``diffmst_tpu.*``) resolve to the port, so ``configs/**/*.yaml`` load
unchanged. A class the port does not have yet raises ``NotPortedError``,
which names its ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Sequence

import yaml

__all__ = ["CLASS_ALIASES", "NotPortedError", "resolve", "instantiate", "load_config", "deep_merge"]

# reference class_path -> the port's implementation
CLASS_ALIASES: Dict[str, str] = {
    "mst.modules.AdvancedMixConsole": "diffmst_torch.console.AdvancedMixConsole",
    "mst.modules.BasicMixConsole": "diffmst_torch.console.BasicMixConsole",
    "mst.modules.MixStyleTransferModel": "diffmst_torch.models.MixStyleTransferModel",
    "mst.modules.SpectrogramEncoder": "diffmst_torch.models.SpectrogramEncoder",
    "mst.modules.TransformerController": "diffmst_torch.models.TransformerController",
    "mst.modules.WaveformTransformerEncoder": "diffmst_torch.models.WaveformTransformerEncoder",
    "mst.modules.ParameterProjector": "diffmst_torch.models.ParameterProjector",
    "mst.modules.Remixer": "diffmst_torch.train.Remixer",
    "mst.fx_encoder.FXencoder": "diffmst_torch.models.FXencoder",
    "mst.panns.Cnn14": "diffmst_torch.models.Cnn14",
    "mst.system.System": "diffmst_torch.train.System",
    "mst.param_system.ParameterEstimationSystem": "diffmst_torch.train.ParameterEstimationSystem",
    "mst.loss.AudioFeatureLoss": "diffmst_torch.losses.AudioFeatureLoss",
    "auraloss.freq.MultiResolutionSTFTLoss": "diffmst_torch.losses.MultiResolutionSTFTLoss",
    "mst.dataloader.MultitrackDataModule": "diffmst_torch.data.MultitrackDataModule",
    "mst.dataloader.MixDataModule": "diffmst_torch.data.MixDataModule",
    "mst.mixing.naive_random_mix": "diffmst_torch.mixing.naive_random_mix",
    "mst.mixing.knowledge_engineering_mix": "diffmst_torch.mixing.knowledge_engineering_mix",
}

# The JAX package's objects that the port does not have yet, by the ROADMAP
# item (Queue 1) that ports them. Empty: every class a config can name is
# ported (the trainer settings the port lacks are refused by main_torch.py).
_NOT_PORTED: Dict[str, str] = {}


class NotPortedError(ImportError):
    """A class path whose target the port does not have yet."""


def _port_path(class_path: str) -> str:
    class_path = CLASS_ALIASES.get(class_path, class_path)
    if class_path.startswith("diffmst_tpu."):
        class_path = "diffmst_torch." + class_path[len("diffmst_tpu."):]
    return class_path


def resolve(class_path: str) -> Any:
    """Import the object named by a dotted path, after aliasing.

    Walks attribute chains past the module boundary, so classmethod factories
    work as class paths too (``diffmst_tpu.models.MixStyleTransferModel.build``).
    """
    target = _port_path(class_path)
    parts = target.split(".")
    last_err: Exception | None = None
    for i in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:i])
        try:
            obj = importlib.import_module(mod_name)
        except ModuleNotFoundError as e:
            # only "this prefix is not a module" continues the walk; a missing
            # dependency inside an existing module is a real error
            if e.name and (mod_name == e.name or mod_name.startswith(e.name + ".")):
                last_err = e
                continue
            raise
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError as e:
            item = _NOT_PORTED.get(parts[-1])
            if item is not None:
                raise NotPortedError(
                    f"{class_path!r} is not ported to diffmst_torch yet: ROADMAP Queue 1, item {item}"
                ) from e
            raise ImportError(f"cannot resolve {class_path!r}: {e}") from e
        return obj
    raise ImportError(f"cannot resolve {class_path!r}: {last_err}")


def instantiate(node: Any, **overrides: Any) -> Any:
    """Recursively build a config node.

    ``{class_path: X, init_args: {...}}`` becomes ``X(**init_args,
    **overrides)`` with nested nodes built first. A bare class-path string
    that is a key of ``CLASS_ALIASES`` resolves to its object (the reference
    passes ``mix_fn: mst.mixing.naive_random_mix`` so).
    """
    if isinstance(node, dict) and "class_path" in node:
        cls = resolve(node["class_path"])
        kwargs = {k: instantiate(v) for k, v in (node.get("init_args") or {}).items()}
        kwargs.update(overrides)
        return cls(**kwargs)
    if isinstance(node, str) and node in CLASS_ALIASES:
        return resolve(node)
    if isinstance(node, dict):
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def _switches_class(base: Dict, over: Dict) -> bool:
    """Both nodes name a class, and not the same one (after aliasing)."""
    return ("class_path" in base and "class_path" in over
            and _port_path(base["class_path"]) != _port_path(over["class_path"]))


def deep_merge(base: Dict, over: Dict) -> Dict:
    """``over`` merged into ``base``, dicts recursively.

    A node whose ``class_path`` the overlay changes takes the overlay's
    node whole: the base's ``init_args`` belonged to the other class, and
    LightningCLI (jsonargparse) likewise drops them on a class change. The
    JAX package's merge keeps them (ROADMAP Queue 3), so ``naive.yaml`` +
    ``naive+feat.yaml`` would hand MRSTFT's FFT sizes to AudioFeatureLoss.
    """
    out = dict(base)
    for k, v in over.items():
        old = out.get(k)
        if isinstance(v, dict) and isinstance(old, dict) and not _switches_class(old, v):
            out[k] = deep_merge(old, v)
        else:
            out[k] = v
    return out


def load_config(paths: Sequence[str]) -> Dict[str, Any]:
    """Overlay YAML config files left to right (repeated ``-c`` semantics)."""
    merged: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            cfg = yaml.safe_load(f) or {}
        merged = deep_merge(merged, cfg)
    return merged
