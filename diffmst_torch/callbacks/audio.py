"""Audio-logging callbacks.

Port of ``diffmst_tpu/callbacks/audio.py``:

  * ``LogAudioCallback`` — after validation, write the reference and
    predicted mixes of a few examples (each peak-normalized, joined by 1 s
    gaps) and a per-track parameter table, denormalized through the port
    console's ``param_dicts`` when one is attached;
  * ``LogReferenceMix`` — fixed songs rendered against fixed reference
    mixes at every validation epoch, through the port's ``run_diffmst`` (on
    the card: the console's kernels, K2 by default);
  * ``save_param_table`` — the table as JSON.

The port's Trainer calls ``on_validation_end(epoch, system, outputs,
metrics)`` with the last validation batch's outputs (tensors on the
System's device) and the ``System`` as the state. ``LogReferenceMix``
takes ``model_apply(system)``, which returns the (tracks, ref) ->
parameters callable that ``run_diffmst`` calls; ``system_model_apply`` is
one, running the System's model in eval mode without gradients.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from diffmst_torch.data.audio_io import read_audio, write_audio

__all__ = ["LogAudioCallback", "LogReferenceMix", "save_param_table", "system_model_apply"]


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host NumPy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class LogAudioCallback:
    def __init__(
        self,
        output_dir: str = "logs/audio",
        sample_rate: int = 44100,
        num_examples: int = 2,
        gap_seconds: float = 1.0,
        mix_console=None,
    ) -> None:
        self.output_dir = output_dir
        self.sample_rate = sample_rate
        self.num_examples = num_examples
        self.gap_seconds = gap_seconds
        self.mix_console = mix_console

    def on_validation_end(self, epoch: int, state, audio: dict, metrics: dict):
        os.makedirs(self.output_dir, exist_ok=True)
        gap = np.zeros((2, int(self.gap_seconds * self.sample_rate)), np.float32)
        clips_by_key = {k: _host(audio[k]) for k in ("ref_mix_a", "ref_mix_b", "pred_mix_b") if k in audio}
        n = min(self.num_examples, clips_by_key["pred_mix_b"].shape[0])
        for i in range(n):
            clips = []
            for a in clips_by_key.values():
                peak = np.abs(a[i]).max()
                clips.extend([a[i] / max(peak, 1e-8), gap])
            write_audio(
                os.path.join(self.output_dir, f"epoch{epoch:04d}_ex{i}.wav"),
                np.concatenate(clips, axis=-1),
                self.sample_rate,
            )
        # the per-track parameter table, denormalized by the console when
        # one is attached, else the normalized vectors
        if "pred_params" in audio:
            tp, fp, mp = (None if p is None else torch.as_tensor(_host(p)) for p in audio["pred_params"])
            path = os.path.join(self.output_dir, f"epoch{epoch:04d}_params.json")
            if self.mix_console is not None:
                td, _, _ = self.mix_console.param_dicts(tp, fp, mp)
                save_param_table(path, td)
            else:
                save_param_table(path, {"normalized": {"track": tp, "fx_bus": fp, "master_bus": mp}})

    def on_log(self, tag: str, metrics: dict) -> None:
        pass


def system_model_apply(system):
    """A ``model_apply`` for ``LogReferenceMix``: the System's model on
    (tracks, ref) tensors, in eval mode and without gradients; the model's
    mode is restored after each call."""

    def apply(tracks, ref):
        model = system.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(tracks, ref)
        finally:
            model.train(was_training)

    return apply


class LogReferenceMix:
    """Render fixed songs against fixed reference mixes each val epoch, on
    the state's (the System's) device: the card unless it says otherwise."""

    def __init__(
        self,
        root_dirs: Sequence[str],
        ref_mixes: Sequence[str],
        output_dir: str = "logs/reference_mix",
        sample_rate: int = 44100,
        length: int = 131072,
        model_apply=None,
        mix_console=None,
    ) -> None:
        self.root_dirs = list(root_dirs)
        self.ref_mixes = list(ref_mixes)
        self.output_dir = output_dir
        self.sample_rate = sample_rate
        self.length = length
        self.model_apply = model_apply
        self.mix_console = mix_console

    def on_validation_end(self, epoch: int, state, audio: dict, metrics: dict):
        if self.model_apply is None or self.mix_console is None:
            return
        from diffmst_torch.utils.inference import run_diffmst

        device = getattr(state, "device", None)
        os.makedirs(self.output_dir, exist_ok=True)
        for song_dir, ref_path in zip(self.root_dirs, self.ref_mixes):
            try:
                stems = []
                for f in sorted(os.listdir(song_dir)):
                    if f.endswith(".wav"):
                        a, _ = read_audio(os.path.join(song_dir, f), 0, self.length * 2)
                        stems.append(a.mean(axis=0))
                if not stems:
                    continue
                tracks = np.stack(stems)[None]
                ref, _ = read_audio(ref_path, 0, self.length * 2)
                mix, *_ = run_diffmst(
                    tracks, ref[None], self.model_apply(state), self.mix_console,
                    analysis_len=self.length, device=device,
                )
                name = os.path.basename(song_dir.rstrip("/"))
                write_audio(
                    os.path.join(self.output_dir, f"epoch{epoch:04d}_{name}.wav"),
                    mix[0] / max(np.abs(mix).max(), 1e-8),
                    self.sample_rate,
                )
            except (OSError, ValueError):
                continue

    def on_log(self, tag: str, metrics: dict) -> None:
        pass


def save_param_table(path: str, track_param_dict: dict) -> None:
    """Write the per-track denormalized parameter table as JSON (the
    reference logs a wandb.Table)."""
    table = {
        eff: {k: _host(v).tolist() for k, v in params.items() if v is not None}
        for eff, params in track_param_dict.items()
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
