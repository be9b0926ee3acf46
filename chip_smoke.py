#!/usr/bin/env python3
"""Serve and train the PyTorch port on one CUDA card, and check its kernels.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card and the CUDA toolkit (``nvcc``); it builds the
port's kernels from ``diffmst_torch/kernels/csrc`` into
``build/diffmst_torch_kernels/`` at first use. Phases:

  1. device: the card's name and power limit;
  2. build: every kernel, timed;
  3. kernels: K1 (one-pole scan) and K2 (fused compressor) at the serving
     shapes, and their backward kernels (K1's with a per-row and, as K4's,
     a per-sample alpha; K2's, with the envelope that K2's forward writes
     for it) at the training shapes, against their plain PyTorch versions,
     with times and bounds;
  4. reference: a small song rendered on the card and on the CPU (the
     kernels' plain versions) with the same weights;
  5. serving: three 60 s, 8-track requests through ``run_diffmst`` with the
     full-width model (``MixStyleTransferModel.build()``, random weights from
     a seeded generator) and ``AdvancedMixConsole`` (compressor "auto" = K2);
  6. K1 path: request 1 again with ``comp_smoother="scan"`` (K1), held
     against the K2 render;
  7. profile: request 2 once more under ``torch.profiler``, the card's busy
     share and its largest kernels;
  8. training: the Method-1 step (``diffmst_torch.train.System``) at the
     reference recipe, batch 4 x 8 tracks x 262,144 samples: three steps
     with the compressor "auto" (K2 forward and backward), then one with
     "scan" (K1 forward and backward), whose gradients are held against
     the K2 path's on the same batch and weights; steps/s, audio seconds
     per second, peak memory and launches per step;
  9. training profile: one more step under ``torch.profiler``, the card's
     busy share, the time of the model, the console and the loss forward
     and backward, and the largest kernels.

Every check raises on failure. The line before the last is a JSON object
with one entry per kernel; the last line is the result JSON. Float32
matrix products and convolutions run without TF32.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SR = 44100.0
WINDOW = 262144  # the serving analysis window and the training example length
HALF = WINDOW // 2  # the training step renders and differentiates one half
SONG_S = 60.0
N_TRACKS = 8
REPEATS = 20

# Peak device-memory rates (bytes/s) and float32 rate outside the tensor
# cores (FLOP/s) of an H100, by form factor (NVIDIA data sheets).
HBM_RATE = {"sxm": 3.35e12, "pcie": 2.0e12}
FP32_RATE = {"sxm": 67e12, "pcie": 51e12}


def line(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ------------------------------------------------------------------ timing


def time_ms(fn, flush: torch.Tensor, hide_host: bool = True) -> float:
    """Median time of ``fn`` on the card over REPEATS calls, each timed with
    CUDA events after the L2 cache is overwritten. With ``hide_host`` the
    card first spins for about 10 ms, so the host has enqueued all of the
    call's launches before the first event and the time is the device's
    alone; without it the time includes the host's launch overhead."""
    fn()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ------------------------------------------------------------------- songs


def synth_song(seed: int, n_tracks: int, seconds: float, quiet_track: int | None):
    """(1, n_tracks, N) stems and a (1, 2, N) reference: enveloped noise and
    tones from ``seed``; ``quiet_track`` sits at -90 LUFS, under the gate."""
    from diffmst_torch.ops.loudness import integrated_loudness

    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n, dtype=np.float64) / SR
    tracks = np.empty((1, n_tracks, n), np.float32)
    for k in range(n_tracks):
        rate = rng.uniform(0.5, 4.0)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
        f0 = rng.uniform(60.0, 2000.0)
        tone = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2.0 * f0 * t)
        noise = rng.standard_normal(n)
        mix = rng.uniform(0.1, 0.9)
        tracks[0, k] = rng.uniform(0.05, 0.5) * env**2 * (mix * tone + (1.0 - mix) * noise)
    if quiet_track is not None:
        x = tracks[0, quiet_track]
        lufs = integrated_loudness(x[:WINDOW], SR)
        tracks[0, quiet_track] = x * np.float32(10.0 ** ((-90.0 - lufs) / 20.0))
    ref_env = 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t)
    ref = (0.2 * ref_env * rng.standard_normal((1, 2, n))).astype(np.float32)
    return tracks, ref


# ------------------------------------------------------------------ phases


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    line("[device]", name, "| count", torch.cuda.device_count())
    line("[device] nvidia-smi:", smi)
    line("[device] tf32 off: cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32,
         "matmul.allow_tf32 =", torch.backends.cuda.matmul.allow_tf32)
    form = "pcie" if "pcie" in (name + smi).lower() else "sxm"
    return name, smi, form


def phase_build():
    from diffmst_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_kernels()
    line(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for src, log in sorted(_build.build_log.items()):
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                line(f"[build] {src}: {ln.strip()[:150]}")


def _static_gain_db(x, thr, ratio, knee):
    """The compressor's soft-knee gain in dB, (B, T), from audio x."""
    from diffmst_torch.ops.compressor import _static_gain_db as gain

    x_db = 20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8))
    return gain(x_db, thr[:, None], ratio[:, None], knee[:, None])


def phase_kernels(form: str):
    """K1 and K2 against their plain versions at the serving shapes."""
    from diffmst_torch.kernels import comp_fused, scan1p
    from diffmst_torch.ops.compressor import _ballistics_coeff

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    rate = HBM_RATE[form]
    stats = {}

    def audio(rows):
        env = torch.linspace(0.02, 1.0, WINDOW, device=dev)
        x = torch.randn(rows, WINDOW, device=dev, generator=gen) * env
        return x / x.abs().amax(dim=-1, keepdim=True)  # peak-normalized to 1

    def params(rows):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(rows, device=dev, generator=gen)  # noqa: E731
        return u(-40.0, -6.0), u(1.5, 10.0), u(1.0, 250.0), u(3.0, 12.0), u(0.0, 6.0)

    def vs64(y, y_plain, y64):
        """Max-abs distance of the kernel's and the plain version's outputs
        from a float64 run of the plain version."""
        return [(t.double() - y64).abs().max().item() for t in (y, y_plain)]

    def record(name, shape, err, err64, fn, plain_fn, nbytes, flops, launches, reported, rel=None):
        ms, plain_ms = time_ms(fn, flush), time_ms(plain_fn, flush)
        call_ms = time_ms(fn, flush, hide_host=False)
        bound_ms = max(nbytes / rate, flops / FP32_RATE[form]) * 1e3
        by = "bytes" if nbytes / rate >= flops / FP32_RATE[form] else "operations"
        if err64 is not None:
            line(f"[kernels] {name} {shape}: max_abs_err {err:.3g}"
                 f" (vs float64: kernel {err64[0]:.3g}, plain {err64[1]:.3g})")
        else:
            line(f"[kernels] {name} {shape}: max_abs_err {err:.3g}, max relative error "
                 + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
        line(f"[kernels] {name} {shape}: {ms:.4f} ms ({call_ms:.4f} ms a call with the host)"
             f" | plain {plain_ms:.4f} ms | bound {bound_ms * 1e3:.1f} us ({by}) | {launches} launches")
        s = stats.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": None})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if rel:
            s["max_rel_err"] = max(s["max_rel_err"] or 0.0, *rel.values())
        if reported:  # the track chain's shape
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, shape=shape)

    # K1: y[n] = a y[n-1] + (1 - a) g[n], g the compressor's gain in dB
    for rows, per_sample in ((32, False), (8, False), (32, True)):
        thr, ratio, attack, knee, _ = params(rows)
        g = _static_gain_db(audio(rows), thr, ratio, knee).contiguous()
        if per_sample:  # attack coefficients of 1-250 ms, one per sample
            ms_t = 1.0 + 249.0 * torch.rand(rows, WINDOW, device=dev, generator=gen)
            a = _ballistics_coeff(ms_t, SR).contiguous()
            b = ((1.0 - a) * g).contiguous()
        else:
            a = _ballistics_coeff(attack, SR).contiguous()
            b = ((1.0 - a)[:, None] * g).contiguous()
        scan1p.onepole_core.launches = 0
        y = scan1p.onepole_core(b, a)
        torch.cuda.synchronize()
        y_plain = scan1p.onepole_core_plain(b, a)
        err = (y - y_plain).abs().max().item()
        err64 = vs64(y, y_plain, scan1p.onepole_core_plain(b.double(), a.double()))
        require(bool(torch.isfinite(y).all()), "K1 output finite")
        require(err <= 1e-3, f"K1 {rows}x{WINDOW} agrees with its plain version in dB ({err})")
        n = rows * WINDOW
        nbytes = n * (12 if per_sample else 8) + (0 if per_sample else rows * 4)
        shape = f"{rows}x{WINDOW}" + (" alpha/sample" if per_sample else "")
        record("onepole_core", shape, err, err64, lambda: scan1p.onepole_core(b, a),
               lambda: scan1p.onepole_core_plain(b, a), nbytes, 2 * n,
               scan1p.onepole_core.launches, rows == 32 and not per_sample)

    # K2 on the track chain (32 rows, lookahead 2048) and master (8, 1024)
    for rows, lookahead in ((32, 2048), (8, 1024)):
        x = audio(rows).contiguous()
        xd = torch.roll(x, lookahead, dims=-1)
        thr, ratio, attack, knee, makeup = params(rows)
        alpha = _ballistics_coeff(attack, SR)
        args = (x, xd, thr, ratio, knee, alpha, makeup)
        comp_fused.compressor_fused_gain.launches = 0
        y = comp_fused.compressor_fused_gain(*args)
        torch.cuda.synchronize()
        y_plain = comp_fused.compressor_fused_gain_plain(*args)
        err = (y - y_plain).abs().max().item()
        err64 = vs64(y, y_plain, comp_fused.compressor_fused_gain_plain(*(t.double() for t in args)))
        require(bool(torch.isfinite(y).all()), "K2 output finite")
        require(err <= 1e-4, f"K2 {rows}x{WINDOW} agrees with its plain version ({err})")
        n = rows * WINDOW
        # log, knee (6), one-pole (2), exp, gain (1): 11 float ops and 2
        # transcendentals a sample, counted as 13
        record("compressor_fused_gain", f"{rows}x{WINDOW} lookahead {lookahead}", err, err64,
               lambda: comp_fused.compressor_fused_gain(*args),
               lambda: comp_fused.compressor_fused_gain_plain(*args),
               n * 12 + rows * 5 * 4, 13 * n, comp_fused.compressor_fused_gain.launches, rows == 32)

    def rel_err(a, b):
        return (a.double() - b.double()).abs().max().item() / max(b.double().abs().max().item(), 1e-30)

    def abs_err(pairs):
        return max((a.double() - b.double()).abs().max().item() for a, b in pairs)

    # K1's backward (the reverse one-pole, dalpha a row sum) and, with a
    # per-sample alpha, K4's (dalpha per sample), at the training shapes
    bwd = scan1p.onepole_core_backward
    for rows, per_sample in ((32, False), (8, False), (32, True), (8, True)):
        thr, ratio, attack, knee, _ = params(rows)
        x = audio(rows)[:, :HALF].contiguous()
        a = _ballistics_coeff(attack, SR)
        if per_sample:
            ms_t = 1.0 + 249.0 * torch.rand(rows, HALF, device=dev, generator=gen)
            a = _ballistics_coeff(ms_t, SR)
        a = a.contiguous()
        g = _static_gain_db(x, thr, ratio, knee)
        y = scan1p.onepole_core(((1.0 - a) * g if per_sample else (1.0 - a)[:, None] * g).contiguous(), a)
        dy = torch.randn(rows, HALF, device=dev, generator=gen)
        bwd.launches = bwd.launches_per_sample = 0
        db, da = bwd(dy, a, y)
        torch.cuda.synchronize()
        launches = bwd.launches_per_sample if per_sample else bwd.launches
        db_p, da_p = scan1p.onepole_core_backward_plain(dy, a, y)
        rel = {"db": rel_err(db, db_p), "dalpha": rel_err(da, da_p)}
        require(bool(torch.isfinite(db).all() and torch.isfinite(da).all()), "K1 backward finite")
        require(launches == 1, f"one K1 backward launch ({launches})")
        require(rel["db"] <= 1e-5, f"K1 backward db agrees with its plain version ({rel['db']})")
        require(rel["dalpha"] <= (1e-5 if per_sample else 1e-4),
                f"K1 backward dalpha agrees with its plain version ({rel['dalpha']})")
        n = rows * HALF
        name = "onepole_core_backward" + ("_per_sample" if per_sample else "")
        # read dy, y (and alpha), write db (and dalpha): the per-row alpha
        # and its sum are 8 bytes a row
        nbytes = n * (20 if per_sample else 12) + (0 if per_sample else rows * 8)
        shape = f"{rows}x{HALF}" + (" alpha/sample" if per_sample else "")
        record(name, shape, abs_err(((db, db_p), (da, da_p))), None,
               lambda: bwd(dy, a, y), lambda: scan1p.onepole_core_backward_plain(dy, a, y),
               nbytes, 4 * n, launches, rows == 32, rel)

    # K2's backward on the track chain (32 rows, lookahead 2048) and master (8, 1024)
    bwd = comp_fused.compressor_fused_backward
    for rows, lookahead in ((32, 2048), (8, 1024)):
        x = audio(rows)[:, :HALF].contiguous()
        xd = torch.roll(x, lookahead, dims=-1)
        thr, ratio, attack, knee, makeup = params(rows)
        p = comp_fused._param_rows(thr, ratio, knee, _ballistics_coeff(attack, SR), makeup).contiguous()
        # the forward of a differentiated call: its output and the envelope
        # g_s it writes for the backward, against the plain forward's
        out, env = comp_fused._launch(x, xd, p, 1e-8, envelope=True)
        torch.cuda.synchronize()
        out_p, env_p = comp_fused._forward_plain(x, xd, p, 1e-8)
        fwd_rel = {"out": rel_err(out, out_p), "envelope": rel_err(env, env_p)}
        line(f"[kernels] compressor_fused_gain {rows}x{HALF} lookahead {lookahead}, writing the"
             f" envelope: max relative error out {fwd_rel['out']:.3g}, envelope {fwd_rel['envelope']:.3g}")
        require(bool(torch.isfinite(env).all()), "K2 envelope finite")
        require(max(fwd_rel.values()) <= 1e-5,
                f"K2 output and envelope agree with the plain forward's ({fwd_rel})")
        dy = torch.randn(rows, HALF, device=dev, generator=gen)
        bwd.launches = 0
        got = bwd(x, xd, p, env, dy)
        torch.cuda.synchronize()
        want = comp_fused.compressor_fused_backward_plain(x, xd, p, env_p, dy)
        rel = {"dx": rel_err(got[0], want[0]), "dx_delayed": rel_err(got[1], want[1])}
        rel.update({f"d{k}": rel_err(got[2][i], want[2][i]) for i, k in
                    enumerate(("threshold", "irm1", "knee", "alpha", "makeup"))})
        require(all(bool(torch.isfinite(t).all()) for t in got), "K2 backward finite")
        require(bwd.launches == 1, f"one K2 backward launch ({bwd.launches})")
        require(rel["dx"] <= 1e-5 and rel["dx_delayed"] <= 1e-5,
                f"K2 backward dx, dx_delayed agree with their plain versions ({rel})")
        require(max(v for k, v in rel.items() if k not in ("dx", "dx_delayed")) <= 1e-4,
                f"K2 backward row sums agree with their plain versions ({rel})")
        n = rows * HALF
        # read x, x_delayed, g_s, dy, write dx, dx_delayed; 5 parameters and
        # 5 sums a row. Per sample: exp, log, the knee's derivatives (10),
        # the scan (2), dx (4), the sums (10): 28 operations
        record("compressor_fused_backward", f"{rows}x{HALF} lookahead {lookahead}",
               abs_err(zip(got[:2], want[:2])), None,
               lambda: bwd(x, xd, p, env, dy),
               lambda: comp_fused.compressor_fused_backward_plain(x, xd, p, env_p, dy),
               n * 24 + rows * 40, 28 * n, bwd.launches, rows == 32, rel)
    return stats


def phase_reference():
    """A small song on the card and on the CPU, same weights, same console."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.utils.inference import run_diffmst

    small = dict(embed_dim=32, num_layers=1, nhead=4, n_fft=2048, hop_length=128, cnn_base_width=4)
    tracks, ref = synth_song(7, 3, 100000 / SR, quiet_track=None)
    mixes = {}
    for dev in ("cpu", "cuda"):
        model = MixStyleTransferModel.build(**small, device=dev,
                                            generator=torch.Generator().manual_seed(1))
        console = AdvancedMixConsole(SR, device=dev)
        mixes[dev], *_ = run_diffmst(tracks, ref, model, console, analysis_len=32768, device=dev)
    peak = float(np.abs(mixes["cpu"]).max())
    err = float(np.abs(mixes["cuda"] - mixes["cpu"]).max())
    line(f"[reference] 3x100000 at width 4: card vs cpu max_abs {err:.3g}, peak {peak:.3g}")
    require(np.isfinite(mixes["cuda"]).all(), "reference mix finite")
    require(err <= 1e-4 * max(1.0, peak), f"card mix agrees with the CPU mix ({err})")


def _serve(model, console, seed, fmt="float32"):
    from diffmst_torch.kernels import comp_fused, scan1p
    from diffmst_torch.utils.inference import run_diffmst

    tracks, ref = synth_song(seed, N_TRACKS, SONG_S, quiet_track=N_TRACKS - 1)
    torch.cuda.synchronize()
    scan1p.onepole_core.launches = 0
    comp_fused.compressor_fused_gain.launches = 0
    t0 = time.perf_counter()
    mix, td, _, _ = run_diffmst(tracks, ref, model, console, output_format=fmt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (scan1p.onepole_core.launches, comp_fused.compressor_fused_gain.launches)
    return mix, td, wall, counts


def phase_serving():
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.models import MixStyleTransferModel

    t0 = time.perf_counter()
    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    line(f"[serving] model: {n_params / 1e6:.1f} M params on {next(model.parameters()).device}"
         f" in {time.perf_counter() - t0:.1f} s")
    console = AdvancedMixConsole(SR)
    n = int(SONG_S * SR)
    launches, walls, first = 0, [], None
    for i, (seed, fmt) in enumerate(((1, "float32"), (2, "float32"), (3, "pcm16"))):
        mix, td, wall, (k1, k2) = _serve(model, console, seed, fmt)
        walls.append(wall)
        launches += k2
        mf = mix.astype(np.float32) / (32767.0 if fmt == "pcm16" else 1.0)
        finite = bool(np.isfinite(mf).all())
        rms, peak = float(np.sqrt(np.mean(mf**2))), float(np.abs(mf).max())
        line(f"[serving] request {i + 1} ({fmt}): {wall:.3f} s, {SONG_S / wall:.1f}x realtime,"
             f" K2 launches {k2}, K1 {k1}, finite {finite}, rms {rms:.4g}, peak {peak:.4g}")
        require(mix.shape == (1, 2, n), f"request {i + 1} mix shape {mix.shape}")
        require(mix.dtype == (np.int16 if fmt == "pcm16" else np.float32), "output dtype")
        require(finite and rms > 0.0, f"request {i + 1} mix finite and not silent")
        require(k2 > 0 and k1 == 0, f"request {i + 1} went through K2 only ({k1}, {k2})")
        require(td["compressor"]["ratio"].shape == (1, N_TRACKS - 1), "the quiet track was gated")
        if i == 0:
            first = mix
    return model, first, launches, walls


def phase_k1_path(model, mix_k2):
    from diffmst_torch.console import AdvancedMixConsole

    mix, _, wall, (k1, k2) = _serve(model, AdvancedMixConsole(SR, comp_smoother="scan"), 1)
    err = float(np.abs(mix - mix_k2).max())
    line(f"[k1-path] request 1 with comp_smoother='scan': {wall:.3f} s, K1 launches {k1},"
         f" K2 {k2}, max_abs vs the K2 mix {err:.3g}")
    require(k1 > 0 and k2 == 0, f"the 'scan' render went through K1 only ({k1}, {k2})")
    require(err <= 1e-4, f"K1 mix agrees with the K2 mix ({err})")
    return k1


def phase_profile(model):
    """Request 2 once more under torch.profiler: where the card's time goes."""
    from torch.profiler import ProfilerActivity, profile

    from diffmst_torch.console import AdvancedMixConsole

    console = AdvancedMixConsole(SR)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = _serve(model, console, 2)
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e for e in prof.events() if e.name.startswith("run_diffmst.") and e.device_type != cuda]
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and not e.key.startswith("run_diffmst.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    line(f"[profile] request 2 traced: {wall:.3f} s wall, {busy_ms:.1f} ms of kernels and copies"
         f" on the card ({100.0 * busy_ms / (wall * 1e3):.1f}% busy)")
    for e in ranges:
        line(f"[profile] {e.name:22s} host {e.cpu_time_total / 1e3:7.1f} ms,"
             f" card {e.device_time_total / 1e3:7.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        line(f"[profile] {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x {e.key[:70]}")


# ---------------------------------------------------------------- training

# The reference recipe: configs/models/naive.yaml (the model at full width,
# AdvancedMixConsole(44100) with its ranges, the fx bus off, MRSTFT at FFT
# sizes 512, 2048 and 8192) and configs/data/medley+cambridge-8.yaml (batch
# 4, 8 tracks, 262,144 samples), written out here: the card's machine has
# no YAML reader.
TRAIN_BS, TRAIN_TRACKS = 4, 8
CONSOLE_RANGES = dict(input_min_gain_db=-48.0, input_max_gain_db=48.0, output_min_gain_db=-48.0,
                      output_max_gain_db=48.0, eq_min_gain_db=-12.0, eq_max_gain_db=12.0,
                      min_pan=0.0, max_pan=1.0)
MRSTFT = dict(fft_sizes=(512, 2048, 8192), hop_sizes=(256, 1024, 4096), win_lengths=(512, 2048, 8192))
TRAIN_STEPS = 3


def synth_batch(seed: int):
    """A training batch of enveloped noise and tones, each track at about
    -48 dBFS RMS (the data config normalizes tracks to -48 LUFS)."""
    from diffmst_torch.train import Batch

    rng = np.random.default_rng(seed)
    t = np.arange(WINDOW) / SR
    tracks = np.empty((TRAIN_BS, TRAIN_TRACKS, WINDOW), np.float32)
    for b in range(TRAIN_BS):
        for k in range(TRAIN_TRACKS):
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 4.0) * t + rng.uniform(0, 2 * np.pi))
            tone = np.sin(2 * np.pi * rng.uniform(60.0, 2000.0) * t)
            x = env**2 * (rng.uniform(0.1, 0.9) * tone + rng.standard_normal(WINDOW))
            tracks[b, k] = x * (10.0 ** (-48.0 / 20.0) / np.sqrt(np.mean(x**2)))
    ids = torch.zeros(TRAIN_BS, TRAIN_TRACKS, dtype=torch.int32)
    return Batch(torch.from_numpy(tracks), ids, ids, torch.zeros(TRAIN_BS, TRAIN_TRACKS, dtype=torch.bool),
                 torch.zeros(TRAIN_BS, 2, WINDOW))


def _counters():
    from diffmst_torch.kernels import comp_fused, scan1p

    return {"K1": scan1p.onepole_core, "K1-bwd": scan1p.onepole_core_backward,
            "K2": comp_fused.compressor_fused_gain, "K2-bwd": comp_fused.compressor_fused_backward}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0
    _counters()["K1-bwd"].launches_per_sample = 0


def read_counts() -> dict:
    counts = {k: fn.launches for k, fn in _counters().items()}
    counts["K4-bwd"] = _counters()["K1-bwd"].launches_per_sample
    return counts


def phase_training():
    """The Method-1 step at the reference recipe: three K2 steps, then a K1 step."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.mixing import naive_random_mix
    from diffmst_torch.mixing.naive import draw_mix_params
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    console = AdvancedMixConsole(SR, **CONSOLE_RANGES)  # comp_smoother "auto" = K2
    system = System(model, console, MultiResolutionSTFTLoss(**MRSTFT), SystemConfig(),
                    generator=torch.Generator().manual_seed(1))
    batch = synth_batch(11)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = system.effect_flags(0)
    line(f"[training] model {n_params / 1e6:.1f} M params, batch {TRAIN_BS} x {TRAIN_TRACKS} x {WINDOW},"
         f" flags {flags._asdict()}, lr {system.config.lr}, schedule {system.config.schedule}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, all_counts = [], []
    for step in range(TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        m = system.train_step(batch, flags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        all_counts.append(counts)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        line(f"[training] step {step + 1} (auto = K2): {walls[-1]:.3f} s, loss {loss:.5f},"
             f" grad_norm {gn:.5g}, launches {counts}")
        require(np.isfinite(loss) and np.isfinite(gn), f"step {step + 1} loss and grad_norm finite")
        require(int(m["pred_mix_nonfinite"]) == 0 and int(m["ref_mix_nonfinite"]) == 0,
                f"step {step + 1} mixes finite")
        require(counts["K2"] == 4 and counts["K2-bwd"] == 2 and counts["K1"] == counts["K1-bwd"] == 0,
                f"step {step + 1}: 4 K2 forward and 2 K2 backward launches, no K1 ({counts})")
    peak = torch.cuda.max_memory_allocated()

    # The K1 step against the K2 path at the same weights, batch, reference
    # mix and BatchNorm statistics, with deterministic cuDNN: two K2 passes
    # (the second shows how far the K2 path's gradients move between runs),
    # then the K1 step. All three render the reference through K1, so that
    # the passes differ in the predicted render alone: the MRSTFT loss's L1
    # terms change sign where the two mixes nearly meet, and a reference
    # rendered through K2 instead (4.7e-9 away) flips some of them. The
    # cotangents the console hands the model (at the predicted parameters)
    # compare the two compressor paths' backward passes; the model's
    # gradients carry them through its backward.
    ref_params = draw_mix_params(batch.tracks, console, torch.Generator().manual_seed(2))
    stats = {k: v.clone() for k, v in model.named_buffers()}
    k1_console = AdvancedMixConsole(SR, **CONSOLE_RANGES, comp_smoother="scan")
    system.mix_fn = lambda tracks, _console, generator, **kw: naive_random_mix(
        tracks, k1_console, generator, **kw)

    def grad_pass():
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        for p in system.params:
            p.grad = None
        loss, metrics, out = system.forward(batch, flags, True, ref_params)
        cot = {}
        pred_track, _, pred_master = out["pred_params"]
        pred_track.register_hook(lambda g: cot.__setitem__("track", g.detach().clone()))
        pred_master.register_hook(lambda g: cot.__setitem__("master", g.detach().clone()))
        metrics["grad_norm"] = system.backward(loss)
        return {k: v.detach() for k, v in metrics.items()}, cot

    torch.backends.cudnn.deterministic = True
    reset_counts()
    m2, cot2 = grad_pass()
    g2 = [p.grad.clone() for p in system.params]
    k2_check = read_counts()
    m2b, _ = grad_pass()
    g2b = [p.grad.clone() for p in system.params]
    system.mix_console = k1_console
    reset_counts()
    t0 = time.perf_counter()
    m1, cot1 = grad_pass()
    g1 = [p.grad.clone() for p in system.params]
    system.apply_gradients(m1["grad_norm"])
    system.step += 1
    torch.cuda.synchronize()
    k1_wall = time.perf_counter() - t0
    k1_counts = read_counts()
    torch.backends.cudnn.deterministic = False
    system.mix_console, system.mix_fn = console, naive_random_mix

    def norm(ts):
        return float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))

    spread = norm([a - b for a, b in zip(g2b, g2)]) / norm(g2)
    global_rel = norm([a - b for a, b in zip(g1, g2)]) / norm(g2)
    worst_leaf = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(g1, g2))
    def cotangent_err(name):
        """The K1 cotangents' difference from the K2 ones: in norm, relative
        to the K2 tensor's norm; the largest, relative to its max-abs; and
        the worst parameter (the last axis) relative to its own max-abs,
        with its index."""
        a, b = (c[name].reshape(-1, c[name].shape[-1]).double() for c in (cot1, cot2))
        per = (a - b).abs().amax(dim=0) / b.abs().amax(dim=0).clamp_min(1e-30)
        return (float((a - b).norm() / b.norm()), float((a - b).abs().max() / b.abs().max()),
                float(per.max()), int(per.argmax()))

    cot_errs = {k: cotangent_err(k) for k in ("track", "master")}
    cot_rel = max(e[0] for e in cot_errs.values())
    loss1, loss2 = float(m1["loss"]), float(m2["loss"])
    line(f"[training] step {TRAIN_STEPS + 1} (scan = K1): {k1_wall:.3f} s, loss {loss1:.5f},"
         f" grad_norm {float(m1['grad_norm']):.5g}, launches {k1_counts}")
    line(f"[training] K1 vs K2 on the same batch and weights: loss {loss1:.7f} vs {loss2:.7f};"
         f" the console's cotangents at the predicted parameters differ by {cot_rel:.3g} of their"
         f" norm (of their max-abs: "
         + ", ".join(f"{k} {e[1]:.3g}, worst parameter #{e[3]} {e[2]:.3g}" for k, e in cot_errs.items())
         + f"); the model's gradients by {global_rel:.3g} of their norm (worst leaf"
         f" {worst_leaf:.3g} of its max-abs), where two K2 passes differ by {spread:.3g};"
         f" grad_norm {float(m1['grad_norm']):.7g} vs {float(m2['grad_norm']):.7g}"
         f" vs {float(m2b['grad_norm']):.7g}; a K2 pass (its reference through K1) launched {k2_check}")
    require(np.isfinite(loss1) and np.isfinite(float(m1["grad_norm"])), "K1 step loss and grad_norm finite")
    require(k1_counts["K1"] == 4 and k1_counts["K1-bwd"] == 2 and k1_counts["K2"] == k1_counts["K2-bwd"] == 0,
            f"the K1 step: 4 K1 forward and 2 K1 backward launches, no K2 ({k1_counts})")
    require(abs(loss1 - loss2) <= 1e-5 * abs(loss2), "K1 and K2 losses agree")
    # The predicted mixes still differ by some 1e-9, which flips an L1 sign
    # here and there, and the detector's d x_db / dx = (20 / ln 10) / x has
    # a pole at x = 0: near-silent samples carry large cotangents whose
    # rounding differs between the two paths, and the EQ's gradients sum
    # them. On the card the cotangents differ by up to 4e-3 of their norm
    # (PERF.md, PR 2), hence 2e-2.
    require(abs(float(m1["grad_norm"]) / float(m2["grad_norm"]) - 1.0) <= 1e-4, "K1 and K2 grad_norm agree")
    require(cot_rel <= 2e-2, f"K1 and K2 console cotangents agree ({cot_rel})")
    require(global_rel <= 1e-3, f"K1 and K2 gradients agree ({global_rel}; K2 vs K2 {spread})")

    per_step = sum(walls[1:]) / (len(walls) - 1)
    audio_s = TRAIN_BS * WINDOW / SR
    line(f"[training] steps 2-{TRAIN_STEPS}: {1.0 / per_step:.3f} steps/s ({per_step:.3f} s a step),"
         f" {audio_s / per_step:.1f} s of audio a second ({audio_s:.2f} s a step);"
         f" step 1 {walls[0]:.3f} s; peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    launches = {k: sum(c[k] for c in all_counts) + k1_counts[k] for k in all_counts[0]}
    return system, batch, flags, launches


def phase_train_profile(system, batch, flags):
    """One more K2 step under torch.profiler. CUDA events recorded by hooks
    on the rendered mix and on the predicted parameters split the backward
    into the loss's, the console's and the model's."""
    from torch.profiler import ProfilerActivity, profile

    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "bwd", "loss", "track", "master", "end", "opt")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev["start"].record()
        for p in system.params:
            p.grad = None
        loss, metrics, out = system.forward(batch, flags, True)
        pred_track, _, pred_master = out["pred_params"]
        out["pred_mix_b"].register_hook(lambda g: ev["loss"].record())
        pred_track.register_hook(lambda g: ev["track"].record())
        pred_master.register_hook(lambda g: ev["master"].record())
        ev["bwd"].record()
        grad_norm = system.backward(loss)
        ev["end"].record()
        system.apply_gradients(grad_norm)
        system.step += 1
        ev["opt"].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(np.isfinite(float(loss.detach())), "profiled step loss finite")
    el = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
    console_end = "track" if el("track", "master") < 0 else "master"
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda and not e.key.startswith("system.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    line(f"[train-profile] one step traced: {wall:.3f} s wall, {busy_ms:.1f} ms of kernels and copies"
         f" on the card ({100.0 * busy_ms / (wall * 1e3):.1f}% busy)")
    for e in prof.events():
        if e.name.startswith("system.") and e.device_type != cuda:
            line(f"[train-profile] {e.name:18s} host {e.cpu_time_total / 1e3:8.1f} ms,"
                 f" card {e.device_time_total / 1e3:8.1f} ms")
    line(f"[train-profile] backward split by CUDA events: loss {el('bwd', 'loss'):.1f} ms,"
         f" console {el('loss', console_end):.1f} ms, model {el(console_end, 'end'):.1f} ms;"
         f" forward {el('start', 'bwd'):.1f} ms, optimizer {el('end', 'opt'):.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        line(f"[train-profile] {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x {e.key[:70]}")


def kernel_entry(name, source, replaces, launches, k, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
                max_rel_err=k["max_rel_err"], shape=k["shape"], **extra)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card only")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "diffmst_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(root))

    name, smi, form = phase_device()
    phase_build()
    stats = phase_kernels(form)
    phase_reference()
    model, mix_k2, k2_launches, walls = phase_serving()
    k1_launches = phase_k1_path(model, mix_k2)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    system, batch, flags, train = phase_training()
    phase_train_profile(system, batch, flags)

    scan_cu, comp_cu = ("diffmst_torch/kernels/csrc/scan1p.cu",
                        "diffmst_torch/kernels/csrc/comp_fused.cu")
    # launches: the serving requests (K1 in its one "scan" render) plus the
    # four training steps; K4's backward is on no path (no smoother uses it)
    kernels = [
        kernel_entry("onepole_core", scan_cu, "diffmst_tpu/kernels/scan1p.py:111",
                     k1_launches + train["K1"], stats["onepole_core"],
                     launches_serving=k1_launches, launches_training=train["K1"]),
        kernel_entry("compressor_fused_gain", comp_cu, "diffmst_tpu/kernels/comp_fused.py:98",
                     k2_launches + train["K2"], stats["compressor_fused_gain"],
                     launches_serving=k2_launches, launches_training=train["K2"]),
        kernel_entry("onepole_core_backward", scan_cu,
                     "diffmst_tpu/kernels/scan1p.py:145 (onepole_scan VJP, :142-150)",
                     train["K1-bwd"], stats["onepole_core_backward"]),
        kernel_entry("onepole_core_backward_per_sample", scan_cu,
                     "diffmst_tpu/kernels/scan1p.py:183 (onepole_scan_tv VJP, :176-187)",
                     train["K4-bwd"], stats["onepole_core_backward_per_sample"], on_path=False),
        kernel_entry("compressor_fused_backward", comp_cu,
                     "diffmst_tpu/kernels/comp_fused.py:167 (compressor_fused_gain VJP, :167-176)",
                     train["K2-bwd"], stats["compressor_fused_backward"]),
    ]
    for k in kernels:
        require(k["launches"] > 0 or not k.get("on_path", True), f"{k['name']} launched on its path")
    line(f"[serving] realtime factors {', '.join(f'{SONG_S / w:.1f}x' for w in walls)}"
         f" for {SONG_S:.0f} s, {N_TRACKS}-track songs")
    line(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
