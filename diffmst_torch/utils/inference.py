"""Full-song inference: analysis window, loudness gate, Hann overlap-add render.

Port of ``diffmst_tpu/utils/inference.py::run_diffmst`` on its ``"ola"``
render mode:
  1. crop a 262,144-sample analysis window from the tracks and the reference;
  2. gate tracks below -80 LUFS and normalize the rest to -48 LUFS (host);
  3. one model call on the analysis windows of the kept tracks;
  4. render the whole song on the device in windows of ``analysis_len`` at
     hop ``analysis_len // 2``, ``_RENDER_BS`` windows per console call,
     Hann-weighted (the first window's first half forced to 1) and
     overlap-added by a reshape and shift: window i's second half lands
     exactly on window i+1's first half.
The song goes to the device once and the mix comes back once.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from diffmst_torch.ops.loudness import integrated_loudness
from diffmst_torch.ops.stft import hann_window
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["run_diffmst"]

# Windows per console call.
_RENDER_BS = 4


def _gate(analysis_tracks: np.ndarray, sample_rate: float):
    """Gate tracks below -80 LUFS and normalize the rest to -48 LUFS.

    Returns the kept track indices, a gain per track (0 for gated tracks,
    which keep their rows and render to silence) and the normalized analysis
    windows of the kept tracks.
    """
    keep, norm_analysis = [], []
    gains = np.zeros(analysis_tracks.shape[1], np.float32)
    for i in range(analysis_tracks.shape[1]):
        lufs = integrated_loudness(np.asarray(analysis_tracks[0, i]), sample_rate)
        if not np.isfinite(lufs) or lufs < -80.0:
            continue
        g = np.float32(10.0 ** ((-48.0 - lufs) / 20.0))
        keep.append(i)
        gains[i] = g
        norm_analysis.append(analysis_tracks[0, i] * g)
    if not keep:
        raise ValueError("all tracks gated out (< -80 LUFS)")
    return keep, gains, norm_analysis


def _pcm16_trim(mix: torch.Tensor, total: int) -> torch.Tensor:
    """(2, padded_len) float mix -> (2, total) int16: scale by 32767, round
    half to even, clip."""
    x = torch.round(mix[:, :total] * 32767.0)
    return torch.clamp(x, -32768.0, 32767.0).to(torch.int16)


def _device_ola(
    mix_console,
    use_fx_bus: bool,
    tracks_padded: torch.Tensor,
    gains: torch.Tensor,
    tp: torch.Tensor,
    fp: torch.Tensor,
    mp: torch.Tensor,
    n_windows: int,
    window_len: int,
    group_bs: int,
) -> torch.Tensor:
    """Hann-OLA render of (num_tracks, (n_windows + 1) * hop) raw stems with
    per-track gains (0 for gated tracks) -> (2, (n_windows + 1) * hop)."""
    hop = window_len // 2
    seg_len = (group_bs - 1) * hop + window_len
    tpg = tp.expand(group_bs, -1, -1)
    fpg = fp.expand(group_bs, -1)
    mpg = mp.expand(group_bs, -1)
    rendered = torch.empty(n_windows, 2, window_len, device=tracks_padded.device)
    for i in range(0, n_windows, group_bs):
        seg = tracks_padded[:, i * hop : i * hop + seg_len] * gains[:, None]
        wins = seg.unfold(-1, window_len, hop).transpose(0, 1)  # (group_bs, tracks, L)
        rendered[i : i + group_bs] = mix_console(wins, tpg, fpg, mpg, use_fx_bus=use_fx_bus).mix

    win = torch.from_numpy(hann_window(window_len).copy()).to(rendered.device)
    weights = win.expand(n_windows, window_len).clone()
    weights[0, :hop] = 1.0  # the first window's first half
    weighted = rendered * weights[:, None, :]
    firsts = weighted[:, :, :hop]
    seconds = weighted[:, :, hop:]
    shifted = torch.cat([torch.zeros_like(seconds[:1]), seconds[:-1]], dim=0)
    body = (firsts + shifted).transpose(0, 1).reshape(2, n_windows * hop)
    return torch.cat([body, seconds[-1]], dim=-1)


@torch.inference_mode()
def run_diffmst(
    tracks: np.ndarray,
    ref: np.ndarray,
    model_apply: Callable,
    mix_console,
    track_start_idx: int = 0,
    ref_start_idx: int = 0,
    analysis_len: int = 262144,
    sample_rate: float = 44100.0,
    use_fx_bus: bool = False,
    render_mode: str = "ola",
    output_format: str = "float32",
    device: DeviceLike = None,
) -> Tuple[np.ndarray, dict, dict, dict]:
    """Full-song mix style transfer.

    Args:
      tracks: (1, num_tracks, total_len) raw mono stems (host array).
      ref: (1, 2, ref_len) stereo reference mix (host array).
      model_apply: (tracks, ref_mix) tensors -> (track_params, fx_params,
        master_params), e.g. a ``MixStyleTransferModel`` on ``device``.
      mix_console: console instance rendering on ``device``.
      render_mode: "ola", the reference's Hann overlap-add. The seam-free
        "streaming" mode is not ported yet (it needs the causal EQ, K5).
      output_format: "float32" or "pcm16" (int16, quantized on the device).
      device: where the song is rendered; None means the CUDA device.

    Returns:
      (pred_mix (1, 2, total_len) host array, track_param_dict,
       fx_param_dict, master_param_dict) — the dicts denormalized.
    """
    if output_format not in ("float32", "pcm16"):
        raise ValueError(f"bad output_format {output_format!r}")
    if render_mode != "ola":
        raise NotImplementedError(
            f"render_mode {render_mode!r} is not ported yet (ROADMAP Queue 1, item 8); use 'ola'"
        )
    dev = resolve_device(device)
    total = tracks.shape[-1]
    n_all = tracks.shape[1]
    analysis_tracks = (
        tracks[..., track_start_idx : track_start_idx + analysis_len]
        if total >= analysis_len
        else tracks
    )
    analysis_ref = (
        ref[..., ref_start_idx : ref_start_idx + analysis_len]
        if ref.shape[-1] >= analysis_len
        else ref
    )

    # Each stage is a named range in torch.profiler traces; the ranges cost
    # nothing while no profiler runs.
    with record_function("run_diffmst.gate"):
        keep, gains, norm_analysis = _gate(analysis_tracks, sample_rate)

    group_bs = _RENDER_BS
    hop = analysis_len // 2
    n_windows = -(-total // hop)
    n_windows = -(-n_windows // group_bs) * group_bs
    with record_function("run_diffmst.upload"):
        tracks_dev = torch.zeros(n_all, (n_windows + 1) * hop, device=dev)
        tracks_dev[:, :total] = torch.as_tensor(np.asarray(tracks[0], np.float32)).to(dev)
        gains_dev = torch.from_numpy(gains).to(dev)
        ref_dev = torch.as_tensor(np.asarray(analysis_ref, np.float32)).to(dev)

    with record_function("run_diffmst.model"):
        # one model call on the analysis windows of the kept tracks
        if total >= analysis_len:
            keep_dev = torch.tensor(keep, device=dev)
            seg = tracks_dev[keep_dev, track_start_idx : track_start_idx + analysis_len]
            analysis_dev = (seg * gains_dev[keep_dev, None])[None]
        else:  # a short song: the model sees the whole (shorter) song
            analysis_dev = torch.from_numpy(np.stack(norm_analysis)[None].astype(np.float32)).to(dev)
        tp, fp, mp = model_apply(analysis_dev, ref_dev)
        # scatter the kept tracks' parameters to their slots (gated rows: 0)
        tp_full = torch.zeros(1, n_all, tp.shape[-1], device=dev)
        tp_full[0, keep] = tp[0].float()

    with record_function("run_diffmst.render"):
        mix = _device_ola(
            mix_console, use_fx_bus, tracks_dev, gains_dev, tp_full, fp, mp,
            n_windows, analysis_len, group_bs,
        )
    with record_function("run_diffmst.download"):
        if output_format == "pcm16":
            pred_mix = _pcm16_trim(mix, total).cpu().numpy()[None]
        else:
            pred_mix = mix[:, :total].cpu().numpy()[None]
    td, fd, md = mix_console.param_dicts(tp, fp, mp)
    return pred_mix, td, fd, md
