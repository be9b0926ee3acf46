"""Full-song inference: analysis window, loudness gate, full-song render.

Port of ``diffmst_tpu/utils/inference.py``. ``run_diffmst``:
  1. crop a 262,144-sample analysis window from the tracks and the reference;
  2. gate tracks below -80 LUFS and normalize the rest to -48 LUFS (host);
  3. one model call on the analysis windows of the kept tracks;
  4. render the whole song on the device, ``_RENDER_BS`` windows per console
     call, in one of two modes:
       * ``"ola"`` (the reference's): windows of ``analysis_len`` at hop
         ``analysis_len // 2``, Hann-weighted (the first window's first half
         forced to 1) and overlap-added by a reshape and shift: window i's
         second half lands exactly on window i+1's first half;
       * ``"streaming"`` (overlap-save): blocks of ``analysis_len // 2``,
         each rendered with ``analysis_len // 4`` samples of true left
         context that are then cut away, so consecutive blocks agree with
         one render of the whole song instead of being cross-faded. With a
         causal console (``comp_smoother="decoupled"``,
         ``eq_method="scan"``) the blocks join without seams.
The song goes to the device once and stays there, cached for the next
calls on the same host array (``_device_tracks``, the last
``_TRACK_CACHE_SONGS`` songs); only the gains and the reference travel a
call. The mix comes back once, or stays on the device
(``return_device``). With the fx bus, one reverb noise draw serves the
whole request: every console call takes the same
(``_RENDER_BS``, 2, 12, reverb samples + taps - 1) noise, as every call of
JAX's render takes the request's one key, so window (or block) i convolves
with the impulse response of row i % ``_RENDER_BS``.

``overlap_add_render`` and ``overlap_save_render`` are the same two renders
assembled on the host around a render callable.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from diffmst_torch.ops.loudness import integrated_loudness
from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape
from diffmst_torch.ops.stft import hann_window
from diffmst_torch.utils.device import DeviceLike, resolve_device

__all__ = ["run_diffmst", "overlap_add_render", "overlap_save_render", "clear_track_cache"]

# Windows per console call.
_RENDER_BS = 4


def _render_batched(
    render_window: Callable, wins: np.ndarray, device: torch.device, render_bs: Optional[int] = None
) -> np.ndarray:
    """Render (n, num_tracks, L) host windows in groups of ``render_bs``
    (None: ``_RENDER_BS``; the last group padded with silent windows) on
    ``device``. An exported render has a fixed window batch: pass its
    manifest's ``render_bs``."""
    bs = _RENDER_BS if render_bs is None else render_bs
    outs = []
    for i in range(0, wins.shape[0], bs):
        group = wins[i : i + bs]
        pad = bs - group.shape[0]
        if pad:
            group = np.concatenate([group, np.zeros((pad,) + group.shape[1:], group.dtype)])
        out = render_window(torch.from_numpy(np.ascontiguousarray(group)).to(device))
        outs.append(out[: bs - pad].detach().cpu().numpy())
    return np.concatenate(outs, axis=0)


def overlap_add_render(
    render_window: Callable[[torch.Tensor], torch.Tensor],
    tracks: np.ndarray,
    window_len: int,
    hop: Optional[int] = None,
    render_bs: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Hann overlap-add render of a song, assembled on the host.

    Args:
      render_window: (render_bs, num_tracks, window_len) tensor on
        ``device`` -> (render_bs, 2, window_len) mixes.
      tracks: (1, num_tracks, total_len) normalized stems (host array).
      window_len: the window (the reference's: 262144).
      hop: window start to window start; None means ``window_len // 2``.
      render_bs: windows a call; None means ``_RENDER_BS``.
      device: where the windows go; None means the CUDA device.

    Returns:
      (1, 2, total_len) mix (host array).
    """
    dev = resolve_device(device)
    if hop is None:
        hop = window_len // 2
    total = tracks.shape[-1]
    starts = list(range(0, total, hop))
    wins = []
    for s in starts:
        w = tracks[0, :, s : s + window_len]
        wins.append(np.pad(w, ((0, 0), (0, window_len - w.shape[-1]))))
    rendered = _render_batched(render_window, np.stack(wins), dev, render_bs)

    win = hann_window(window_len).astype(np.float32)
    first = np.concatenate([np.ones(window_len // 2, np.float32), win[window_len // 2 :]])
    out = np.zeros((1, 2, total + window_len), np.float32)
    for i, s in enumerate(starts):
        out[0, :, s : s + window_len] += rendered[i] * (first if i == 0 else win)
    return out[..., :total]


def overlap_save_render(
    render_window: Callable[[torch.Tensor], torch.Tensor],
    tracks: np.ndarray,
    block_len: int,
    context_len: int = 65536,
    render_bs: Optional[int] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Streaming (overlap-save) render of a song, assembled on the host: each
    output block is cut from a render primed with ``context_len`` samples of
    true left context (zeros before the song), so the compressor's state and
    the causal EQ's have converged where the block starts.

    Args:
      render_window: (render_bs, num_tracks, context_len + block_len) tensor
        on ``device`` -> (render_bs, 2, context_len + block_len) mixes.
      tracks: (1, num_tracks, total_len) normalized stems (host array).
      block_len: output samples per block.
      context_len: warm-up samples before each block.
      render_bs: windows a call; None means ``_RENDER_BS``.
      device: where the windows go; None means the CUDA device.

    Returns:
      (1, 2, total_len) mix (host array).
    """
    dev = resolve_device(device)
    total = tracks.shape[-1]
    win_len = context_len + block_len
    starts = list(range(0, total, block_len))
    wins = []
    for s in starts:
        lo = s - context_len
        w = tracks[0, :, max(lo, 0) : s + block_len]
        pad_l = max(0, -lo)
        wins.append(np.pad(w, ((0, 0), (pad_l, win_len - w.shape[-1] - pad_l))))
    rendered = _render_batched(render_window, np.stack(wins), dev, render_bs)

    out = np.zeros((1, 2, len(starts) * block_len), np.float32)
    for i, s in enumerate(starts):
        out[0, :, s : s + block_len] = rendered[i][:, context_len:]
    return out[..., :total]


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


# Device copies of the last few songs' raw stems, least recently used first:
# eval runs call run_diffmst once per (track section x reference section) of
# the same stems, and every call after the first takes the song from here.
_TRACK_CACHE_SONGS = 4
_TRACK_CACHE: "collections.OrderedDict" = collections.OrderedDict()
# Songs copied to a device (cache misses) since import; tests and
# chip_smoke.py read it.
track_uploads = 0


def _device_tracks(tracks: np.ndarray, pad_total: int, offset: int, dev: torch.device) -> torch.Tensor:
    """(num_tracks, pad_total) float32 tensor on ``dev`` holding the (1,
    num_tracks, total) host stems from ``offset`` (zeros elsewhere), cached.

    The key is the host array's identity, its shape, ``pad_total``,
    ``offset`` and the device, as JAX's ``_device_tracks`` with the device
    added; the entry holds the host array, so a recycled ``id`` can never
    alias another song. As in JAX, a host array edited in place between
    calls is not seen: pass a new array, or call ``clear_track_cache``.
    """
    global track_uploads
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (id(tracks), tracks.shape, pad_total, offset, str(dev))
    hit = _TRACK_CACHE.get(key)
    if hit is not None and hit[0] is tracks:
        _TRACK_CACHE.move_to_end(key)
        return hit[1]
    total = tracks.shape[-1]
    padded = torch.zeros(tracks.shape[1], pad_total, device=dev)
    padded[:, offset : offset + total] = torch.as_tensor(np.asarray(tracks[0], np.float32)).to(dev)
    _TRACK_CACHE[key] = (tracks, padded)
    track_uploads += 1
    while len(_TRACK_CACHE) > _TRACK_CACHE_SONGS:
        _TRACK_CACHE.popitem(last=False)
    return padded


def clear_track_cache() -> None:
    """Drop every cached song from the devices."""
    _TRACK_CACHE.clear()


def _pcm16_trim(mix: torch.Tensor, total: int) -> torch.Tensor:
    """(2, padded_len) float mix -> (2, total) int16: scale by 32767, round
    half to even, clip."""
    x = torch.round(mix[:, :total] * 32767.0)
    return torch.clamp(x, -32768.0, 32767.0).to(torch.int16)


def _device_ola(
    mix_console,
    noise: Optional[torch.Tensor],
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
    per-track gains (0 for gated tracks) -> (2, (n_windows + 1) * hop);
    ``noise``: the request's reverb noise, or None without the fx bus."""
    hop = window_len // 2
    seg_len = (group_bs - 1) * hop + window_len
    tpg = tp.expand(group_bs, -1, -1)
    fpg = fp.expand(group_bs, -1)
    mpg = mp.expand(group_bs, -1)
    rendered = torch.empty(n_windows, 2, window_len, device=tracks_padded.device)
    for i in range(0, n_windows, group_bs):
        seg = tracks_padded[:, i * hop : i * hop + seg_len] * gains[:, None]
        wins = seg.unfold(-1, window_len, hop).transpose(0, 1)  # (group_bs, tracks, L)
        rendered[i : i + group_bs] = mix_console(wins, tpg, fpg, mpg, use_fx_bus=noise is not None, noise=noise).mix

    win = torch.from_numpy(hann_window(window_len).copy()).to(rendered.device)
    weights = win.expand(n_windows, window_len).clone()
    weights[0, :hop] = 1.0  # the first window's first half
    weighted = rendered * weights[:, None, :]
    firsts = weighted[:, :, :hop]
    seconds = weighted[:, :, hop:]
    shifted = torch.cat([torch.zeros_like(seconds[:1]), seconds[:-1]], dim=0)
    body = (firsts + shifted).transpose(0, 1).reshape(2, n_windows * hop)
    return torch.cat([body, seconds[-1]], dim=-1)


def _device_overlap_save(
    mix_console,
    noise: Optional[torch.Tensor],
    tracks_padded: torch.Tensor,
    gains: torch.Tensor,
    tp: torch.Tensor,
    fp: torch.Tensor,
    mp: torch.Tensor,
    n_blocks: int,
    block_len: int,
    context_len: int,
    group_bs: int,
) -> torch.Tensor:
    """Overlap-save render of (num_tracks, context_len + n_blocks * block_len)
    raw stems, the song starting after ``context_len`` zeros, with per-track
    gains (0 for gated tracks) -> (2, n_blocks * block_len). Block i renders
    the window [i * block_len, i * block_len + context_len + block_len) and
    keeps its last ``block_len`` samples; ``noise``: the request's reverb
    noise, or None without the fx bus."""
    win_len = context_len + block_len
    seg_len = (group_bs - 1) * block_len + win_len
    tpg = tp.expand(group_bs, -1, -1)
    fpg = fp.expand(group_bs, -1)
    mpg = mp.expand(group_bs, -1)
    rendered = torch.empty(n_blocks, 2, block_len, device=tracks_padded.device)
    for i in range(0, n_blocks, group_bs):
        seg = tracks_padded[:, i * block_len : i * block_len + seg_len] * gains[:, None]
        wins = seg.unfold(-1, win_len, block_len).transpose(0, 1)  # (group_bs, tracks, win_len)
        mix = mix_console(wins, tpg, fpg, mpg, use_fx_bus=noise is not None, noise=noise).mix
        rendered[i : i + group_bs] = mix[:, :, context_len:]
    return rendered.transpose(0, 1).reshape(2, n_blocks * block_len)


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
    return_device: bool = False,
    output_format: str = "float32",
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Union[np.ndarray, torch.Tensor], dict, dict, dict]:
    """Full-song mix style transfer.

    Args:
      tracks: (1, num_tracks, total_len) raw mono stems (host array). The
        song is uploaded once and cached on the device by the array's
        identity (``_device_tracks``): a host array edited in place between
        calls is not seen.
      ref: (1, 2, ref_len) stereo reference mix (host array).
      model_apply: (tracks, ref_mix) tensors -> (track_params, fx_params,
        master_params), e.g. a ``MixStyleTransferModel`` on ``device``.
      mix_console: console instance rendering on ``device``.
      render_mode: "ola", the reference's Hann overlap-add, or "streaming",
        the seam-free overlap-save render (blocks of ``analysis_len // 2``
        after ``analysis_len // 4`` samples of context), meant for a causal
        console (``comp_smoother="decoupled"``, ``eq_method="scan"``).
      return_device: return the mix as a tensor on ``device`` (float32,
        whatever ``output_format`` says) instead of a host array.
      output_format: "float32" or "pcm16" (int16, quantized on the device).
      device: where the song is rendered; None means the CUDA device.
      use_fx_bus: render the fx bus (per-track sends into the reverb).
      generator: where the request's one reverb noise is drawn from
        (``ops.reverb.draw_reverb_noise``); None means a generator seeded 0,
        as JAX's default key 0.
      noise: the request's reverb noise, (``_RENDER_BS``, 2, 12,
        reverb samples + taps - 1), in place of a draw.

    Returns:
      (pred_mix (1, 2, total_len), track_param_dict, fx_param_dict,
       master_param_dict) — the dicts denormalized.
    """
    if output_format not in ("float32", "pcm16"):
        raise ValueError(f"bad output_format {output_format!r}")
    if render_mode not in ("ola", "streaming"):
        raise ValueError(f"bad render_mode {render_mode!r}")
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

    # Window counts round up to a multiple of the group: the extra windows
    # are silence and are trimmed.
    group_bs = _RENDER_BS
    if render_mode == "streaming":
        block_len, context_len = analysis_len // 2, analysis_len // 4
        n_blocks = -(-total // block_len)
        n_blocks = -(-n_blocks // group_bs) * group_bs
        pad_total, offset = context_len + n_blocks * block_len, context_len
    else:
        hop = analysis_len // 2
        n_windows = -(-total // hop)
        n_windows = -(-n_windows // group_bs) * group_bs
        pad_total, offset = (n_windows + 1) * hop, 0
    with record_function("run_diffmst.upload"):
        tracks_dev = _device_tracks(tracks, pad_total, offset, dev)
        gains_dev = torch.from_numpy(gains).to(dev)
        ref_dev = torch.as_tensor(np.asarray(analysis_ref, np.float32)).to(dev)

    with record_function("run_diffmst.model"):
        # one model call on the analysis windows of the kept tracks
        if total >= analysis_len:
            keep_dev = torch.tensor(keep, device=dev)
            start = offset + track_start_idx
            seg = tracks_dev[keep_dev, start : start + analysis_len]
            analysis_dev = (seg * gains_dev[keep_dev, None])[None]
        else:  # a short song: the model sees the whole (shorter) song
            analysis_dev = torch.from_numpy(np.stack(norm_analysis)[None].astype(np.float32)).to(dev)
        tp, fp, mp = model_apply(analysis_dev, ref_dev)
        # scatter the kept tracks' parameters to their slots (gated rows: 0)
        tp_full = torch.zeros(1, n_all, tp.shape[-1], device=dev)
        tp_full[0, keep] = tp[0].float()

    with record_function("run_diffmst.render"):
        if not use_fx_bus:
            noise = None
        elif noise is None:
            shape = reverb_noise_shape(group_bs, 2, mix_console.reverb_num_samples,
                                       mix_console.reverb_num_taps)
            noise = draw_reverb_noise(generator if generator is not None else torch.Generator().manual_seed(0),
                                      shape, dev)
        if render_mode == "streaming":
            mix = _device_overlap_save(
                mix_console, noise, tracks_dev, gains_dev, tp_full, fp, mp,
                n_blocks, block_len, context_len, group_bs,
            )
        else:
            mix = _device_ola(
                mix_console, noise, tracks_dev, gains_dev, tp_full, fp, mp,
                n_windows, analysis_len, group_bs,
            )
    with record_function("run_diffmst.download"):
        if return_device:
            pred_mix = mix[None, :, :total]
        elif output_format == "pcm16":
            pred_mix = _pcm16_trim(mix, total).cpu().numpy()[None]
        else:
            pred_mix = mix[:, :total].cpu().numpy()[None]
    td, fd, md = mix_console.param_dicts(tp, fp, mp)
    return pred_mix, td, fd, md
