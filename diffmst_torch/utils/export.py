"""Ahead-of-time export of the inference graph for serving (``torch.export``).

Port of ``diffmst_tpu/utils/export.py``. A serving host should need neither
the model's nor the console's Python code, only the computation. Two
fixed-shape functions make a full-song style transfer, the split that
``run_diffmst`` uses:

  * ``predict_params(tracks, ref, mask) -> (track_params, fx_params,
    master_params)``: one model call on the analysis windows, ``mask``
    (1, num_tracks) True on padded track slots;
  * ``render_window(wins, tp, fp, mp) -> mix``: the console on a fixed batch
    of ``render_bs`` windows, for the host OLA and overlap-save renderers.

Each is traced by ``torch.export.export`` under ``torch.no_grad()``, the
model in eval mode, and written with ``torch.export.save`` into a directory
beside a JSON manifest. The console's kernels are the ``torch.ops.diffmst``
operators of ``diffmst_torch.kernels`` (K2 by default; K1, K3 and K5 with
the other smoothers and the causal EQ): the graph holds them as nodes, and
on a CUDA export they launch the hand-written kernels. An export is tied to
the device it was made on and to the PyTorch version that made it.

``load_inference_export`` imports ``diffmst_torch.kernels`` (which registers
the operators) and nothing of ``models/`` or ``console/``;
``run_exported`` is ``run_diffmst``'s host pipeline (the loudness gate, the
kept tracks compacted to the front, the padding mask, the windowed render)
on the loaded functions.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

import diffmst_torch.kernels  # noqa: F401  (registers torch.ops.diffmst)
from diffmst_torch.ops.loudness import integrated_loudness
from diffmst_torch.utils.device import resolve_device
from diffmst_torch.utils.inference import overlap_add_render, overlap_save_render

__all__ = [
    "save_inference_export",
    "load_inference_export",
    "run_exported",
    "kernel_nodes",
    "ExportedInference",
]

FORMAT = "diffmst_torch.inference_export.v2"
_MANIFEST = "manifest.json"
_PREDICT = "predict_params.pt2"
_RENDER = "render_window.pt2"


class ExportedInference(NamedTuple):
    """The loaded functions, their manifest, and the two exported programs
    (predict, render) they run."""

    predict_params: Callable
    render_window: Callable
    manifest: dict
    programs: Tuple[torch.export.ExportedProgram, torch.export.ExportedProgram]


class _Render(torch.nn.Module):
    """The console on a batch of windows with one parameter set; with the fx
    bus, the reverb takes ``noise``, a constant of the graph."""

    def __init__(self, mix_console, use_fx_bus: bool, noise: Optional[torch.Tensor]):
        super().__init__()
        self.mix_console = mix_console
        self.use_fx_bus = use_fx_bus
        if noise is not None:
            self.register_buffer("noise", noise)
        else:
            self.noise = None

    def forward(self, wins, tp, fp, mp):
        n = wins.shape[0]
        out = self.mix_console(
            wins, tp.expand(n, -1, -1), fp.expand(n, -1), mp.expand(n, -1),
            use_fx_bus=self.use_fx_bus, noise=self.noise,
        )
        return out.mix


def save_inference_export(
    path: str,
    model: torch.nn.Module,
    mix_console,
    *,
    num_tracks: int,
    analysis_len: int = 262144,
    render_bs: int = 8,
    use_fx_bus: bool = False,
    sample_rate: float = 44100.0,
) -> dict:
    """Export the inference graph into the directory ``path``.

    Args:
      model: a ``MixStyleTransferModel`` with its weights, on the device the
        export is for (set to eval mode here).
      mix_console: console on the same device; its settings are baked in.
      num_tracks: the static track count (a song with fewer tracks is
        padded with silent, masked slots).
      analysis_len: the model's analysis window and the render's window.
      render_bs: windows a render call.
      use_fx_bus: render the fx bus. Its reverb noise, (render_bs, 2, 12,
        reverb samples + taps - 1), is drawn here from a generator seeded 0
        (JAX bakes in key 0) and kept in the graph.

    Returns the manifest.
    """
    dev = next(model.parameters()).device
    model.eval()
    noise = None
    if use_fx_bus:
        from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape

        shape = reverb_noise_shape(render_bs, 2, mix_console.reverb_num_samples, mix_console.reverb_num_taps)
        noise = draw_reverb_noise(torch.Generator().manual_seed(0), shape, dev)
    render = _Render(mix_console, use_fx_bus, noise)

    f32 = dict(dtype=torch.float32, device=dev)
    tracks = torch.zeros(1, num_tracks, analysis_len, **f32)
    ref = torch.zeros(1, 2, analysis_len, **f32)
    mask = torch.zeros(1, num_tracks, dtype=torch.bool, device=dev)
    wins = torch.zeros(render_bs, num_tracks, analysis_len, **f32)
    tp = torch.full((1, num_tracks, mix_console.num_track_control_params), 0.5, **f32)
    fp = torch.full((1, mix_console.num_fx_bus_control_params), 0.5, **f32)
    mp = torch.full((1, mix_console.num_master_bus_control_params), 0.5, **f32)
    with torch.no_grad():
        predict_program = torch.export.export(model, (tracks, ref, mask))
        render_program = torch.export.export(render, (wins, tp, fp, mp))

    manifest = {
        "format": FORMAT,
        "mask_input": True,  # predict_params takes (tracks, ref, pad_mask)
        "num_tracks": num_tracks,
        "analysis_len": analysis_len,
        "render_bs": render_bs,
        "use_fx_bus": use_fx_bus,
        "sample_rate": sample_rate,
        "param_layout": [
            mix_console.num_track_control_params,
            mix_console.num_fx_bus_control_params,
            mix_console.num_master_bus_control_params,
        ],
        "device": dev.type,
    }
    for program in (predict_program, render_program):
        # the example inputs would be saved too: 77 MB of zeros at the
        # reference's shapes (a render batch of 8 x 8 x 262,144 alone)
        program.example_inputs = None
    os.makedirs(path, exist_ok=True)
    torch.export.save(predict_program, os.path.join(path, _PREDICT))
    torch.export.save(render_program, os.path.join(path, _RENDER))
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def kernel_nodes(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """Count of each ``torch.ops.diffmst`` operator's nodes in a graph."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        target = node.target
        if node.op == "call_function" and getattr(target, "namespace", None) == "diffmst":
            name = target.name()
            counts[name] = counts.get(name, 0) + 1
    return counts


def _check_kernels(program: torch.export.ExportedProgram, dev: torch.device, what: str) -> None:
    """Raise unless every ``diffmst`` operator of the graph has a kernel
    registered for ``dev``: the graph would not run, and nothing may take
    its place."""
    key = "CUDA" if dev.type == "cuda" else "CPU"
    for name in kernel_nodes(program):
        if not torch._C._dispatch_has_kernel_for_dispatch_key(name, key):
            raise RuntimeError(f"{what}: the operator {name} has no {key} kernel registered")


def load_inference_export(path: str) -> ExportedInference:
    """Load an export directory into callables, without the model's or the
    console's code. The device is the export's: a CUDA export raises where
    there is no card."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"not a diffmst_torch inference export: {path}")
    dev = resolve_device(manifest["device"])
    programs = tuple(torch.export.load(os.path.join(path, name)) for name in (_PREDICT, _RENDER))
    for program, name in zip(programs, (_PREDICT, _RENDER)):
        _check_kernels(program, dev, os.path.join(path, name))
    predict_module, render_module = (p.module() for p in programs)
    n_tracks = manifest["num_tracks"]

    @torch.no_grad()
    def predict_params(tracks, ref, mask=None):
        # no mask: every slot holds a track
        if mask is None:
            mask = torch.zeros(tracks.shape[0], n_tracks, dtype=torch.bool, device=tracks.device)
        return predict_module(tracks, ref, mask)

    @torch.no_grad()
    def render_window(wins, tp, fp, mp):
        return render_module(wins, tp, fp, mp)

    return ExportedInference(predict_params, render_window, manifest, programs)


def run_exported(
    exported: ExportedInference,
    tracks: np.ndarray,
    ref: np.ndarray,
    render_mode: str = "ola",
) -> np.ndarray:
    """``run_diffmst``'s host pipeline on a loaded export.

    Per-track loudness gate (< -80 LUFS skipped) and normalization to -48
    LUFS on the analysis window, the kept tracks compacted to the front of
    the export's ``num_tracks`` slots and the rest silent and masked (the
    controller's key-padding mask makes that equal to run_diffmst's model
    call on the kept tracks alone), one predict call, and the windowed
    render in groups of the manifest's ``render_bs``.

    Args:
      tracks: (1, n, total_len) raw mono stems, n <= the export's tracks.
      ref: (1, 2, ref_len) stereo reference mix.
      render_mode: "ola", or "streaming": overlap-save blocks of
        ``analysis_len // 2`` after ``analysis_len - analysis_len // 2``
        samples of context (the export's window is fixed).

    Returns:
      (1, 2, total_len) mix (host array).
    """
    if render_mode not in ("ola", "streaming"):
        raise ValueError(f"bad render_mode {render_mode!r}")
    m = exported.manifest
    num_tracks, analysis_len, sr = m["num_tracks"], m["analysis_len"], m["sample_rate"]
    dev = resolve_device(m["device"])
    if tracks.shape[1] > num_tracks:
        raise ValueError(f"{tracks.shape[1]} tracks > export's static {num_tracks}")
    total = tracks.shape[-1]

    def crop_or_pad(x, n):
        if x.shape[-1] >= n:
            return x[..., :n]
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])

    analysis_tracks = crop_or_pad(tracks, analysis_len)
    analysis_ref = crop_or_pad(ref, analysis_len).astype(np.float32)

    norm = np.zeros((1, num_tracks, total), np.float32)
    norm_analysis = np.zeros((1, num_tracks, analysis_len), np.float32)
    kept = 0
    for i in range(tracks.shape[1]):
        lufs = integrated_loudness(np.asarray(analysis_tracks[0, i]), sr)
        if not np.isfinite(lufs) or lufs < -80.0:
            continue
        g = np.float32(10.0 ** ((-48.0 - lufs) / 20.0))
        norm[0, kept] = tracks[0, i] * g
        norm_analysis[0, kept] = analysis_tracks[0, i] * g
        kept += 1
    if kept == 0:
        raise ValueError("all tracks gated out (< -80 LUFS)")
    pad_mask = np.zeros((1, num_tracks), bool)
    pad_mask[0, kept:] = True  # silent filler slots: masked in attention

    tp, fp, mp = exported.predict_params(
        torch.from_numpy(norm_analysis).to(dev),
        torch.from_numpy(analysis_ref).to(dev),
        torch.from_numpy(pad_mask).to(dev),
    )

    def render(wins):
        return exported.render_window(wins, tp, fp, mp)

    render_bs = m["render_bs"]
    if render_mode == "streaming":
        return overlap_save_render(
            render, norm, block_len=analysis_len // 2,
            context_len=analysis_len - analysis_len // 2, render_bs=render_bs, device=dev,
        )
    return overlap_add_render(render, norm, analysis_len, render_bs=render_bs, device=dev)
