"""Mixing by gradient descent alone, with the PyTorch port: no network, the
console's parameters optimized directly (the counterpart of
``scripts/online.py``).

Adam optimizes the raw, sigmoid-squashed console parameters against the
audio-feature loss between the console's mix of one analysis block and the
reference's block, through the differentiated console (on the card: K2
forward and K2's backward kernel); the whole song is then rendered block by
block (Hann overlap-add) with the optimized parameters.

    python scripts/online_torch.py --track_dir DIR --ref REF.wav --output OUT.wav \
        [--n_iters 250] [--lr 0.01] [--block_start 0] [--block_len 262144]

It runs on the CUDA device unless given ``--device cpu``. ``optimize_params``
is also the cleanest end-to-end check that the loss's gradients flow
through the whole console.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffmst_torch.console import AdvancedMixConsole  # noqa: E402
from diffmst_torch.losses import AudioFeatureLoss  # noqa: E402
from diffmst_torch.utils.device import resolve_device, use_full_float32  # noqa: E402
from diffmst_torch.utils.inference import overlap_add_render  # noqa: E402

_GROUPS = ("track", "fx", "master")


def init_raw_params(bs: int, num_tracks: int, console, generator: torch.Generator) -> dict:
    """0.1 x standard normal raw parameters, drawn on the generator's device
    in the order track (bs, num_tracks, P_t), fx bus (bs, P_f), master bus
    (bs, P_m)."""
    shapes = (
        (bs, num_tracks, console.num_track_control_params),
        (bs, console.num_fx_bus_control_params),
        (bs, console.num_master_bus_control_params),
    )
    return {
        name: 0.1 * torch.randn(shape, generator=generator, device=generator.device)
        for name, shape in zip(_GROUPS, shapes)
    }


def optimize_params(
    tracks: torch.Tensor,
    ref_mix: torch.Tensor,
    console,
    loss_fn=None,
    n_iters: int = 250,
    lr: float = 0.01,
    use_fx_bus: bool = False,
    generator: Optional[torch.Generator] = None,
    log_every: int = 50,
    init_raw: Optional[dict] = None,
):
    """Adam on sigmoid(raw parameters) against the block's loss.

    Args:
      tracks: (bs, num_tracks, T) stems on the console's device.
      ref_mix: (bs, 2, T) reference block.
      loss_fn: (mix, ref) -> a scalar or a dict of scalars (summed after a
        mean each); default ``AudioFeatureLoss()``.
      generator: where the initial raw parameters are drawn
        (``init_raw_params``) and, with the fx bus, the reverb noise after
        them; None means a CPU generator seeded 0.
      init_raw: {"track", "fx", "master"} raw parameters in place of the
        draw (the tests pass JAX's).

    ``torch.optim.Adam`` at optax's defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root), as the JAX script's ``optax.adam(lr)``.

    Returns:
      (track_params, fx_params, master_params) in (0, 1), and the losses of
      every ``log_every``-th iteration and of the last.
    """
    if loss_fn is None:
        loss_fn = AudioFeatureLoss()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    bs, num_tracks, _ = tracks.shape
    if init_raw is None:
        init_raw = init_raw_params(bs, num_tracks, console, generator)
    raw = {k: torch.as_tensor(np.array(init_raw[k]) if isinstance(init_raw[k], np.ndarray) else init_raw[k])
           .to(tracks.device, tracks.dtype).clone().requires_grad_(True) for k in _GROUPS}
    noise = None
    if use_fx_bus:
        from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape

        shape = reverb_noise_shape(bs, 2, console.reverb_num_samples, console.reverb_num_taps)
        noise = draw_reverb_noise(generator, shape, tracks.device, tracks.dtype)
    opt = torch.optim.Adam([raw[k] for k in _GROUPS], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def total_loss():
        out = console(
            tracks, *(torch.sigmoid(raw[k]) for k in _GROUPS),
            use_fx_bus=use_fx_bus, noise=noise,
        )
        loss = loss_fn(out.mix, ref_mix)
        if isinstance(loss, dict):
            loss = sum(torch.mean(v) for v in loss.values())
        return loss

    history = []
    for i in range(n_iters):
        opt.zero_grad(set_to_none=True)
        loss = total_loss()
        loss.backward()
        opt.step()
        if (i % log_every) == 0 or i == n_iters - 1:
            history.append(float(loss.detach()))
            print(f"iter {i}: loss {history[-1]:.6f}", flush=True)
    with torch.no_grad():
        return (*(torch.sigmoid(raw[k]) for k in _GROUPS), history)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track_dir", required=True, help="directory of mono stem wavs")
    ap.add_argument("--ref", required=True, help="stereo reference mix wav")
    ap.add_argument("--output", required=True)
    ap.add_argument("--n_iters", type=int, default=250)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--block_start", type=int, default=0)
    ap.add_argument("--block_len", type=int, default=262144)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from diffmst_torch.data import read_audio, write_audio
    from diffmst_torch.ops.loudness import integrated_loudness
    from scripts.run_torch import load_stems

    dev = resolve_device(args.device)
    use_full_float32()
    tracks = load_stems(args.track_dir)

    # each stem at -48 LUFS
    for i in range(tracks.shape[1]):
        lufs = integrated_loudness(tracks[0, i], 44100.0)
        if np.isfinite(lufs):
            tracks[0, i] *= 10 ** ((-48.0 - lufs) / 20.0)

    ref, _ = read_audio(args.ref)
    ref = ref[None, :, args.block_start : args.block_start + args.block_len]

    console = AdvancedMixConsole(44100.0, device=str(dev))
    block = torch.from_numpy(
        np.ascontiguousarray(tracks[..., args.block_start : args.block_start + args.block_len])
    ).to(dev)
    tp, fp, mp, hist = optimize_params(
        block, torch.from_numpy(np.ascontiguousarray(ref)).to(dev), console,
        n_iters=args.n_iters, lr=args.lr,
    )

    @torch.no_grad()
    def render(wins):
        n = wins.shape[0]
        return console(wins, tp.expand(n, -1, -1), fp.expand(n, -1), mp.expand(n, -1),
                       use_fx_bus=False).mix

    mix = overlap_add_render(render, tracks, args.block_len, device=dev)
    write_audio(args.output, mix[0] / max(np.abs(mix).max(), 1e-8), 44100)
    print(f"wrote {args.output}; final loss {hist[-1]:.6f}")
    return hist


if __name__ == "__main__":
    main()
