#!/usr/bin/env python3
"""Serve full songs through the PyTorch port on one CUDA card, and check its kernels.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card and the CUDA toolkit (``nvcc``); it builds the
port's kernels from ``diffmst_torch/kernels/csrc`` into
``build/diffmst_torch_kernels/`` at first use. Phases:

  1. device: the card's name and power limit;
  2. build: every kernel, timed;
  3. kernels: K1 (one-pole scan) and K2 (fused compressor) at the serving
     shapes against their plain PyTorch versions, with times and bounds;
  4. reference: a small song rendered on the card and on the CPU (the
     kernels' plain versions) with the same weights;
  5. serving: three 60 s, 8-track requests through ``run_diffmst`` with the
     full-width model (``MixStyleTransferModel.build()``, random weights from
     a seeded generator) and ``AdvancedMixConsole`` (compressor "auto" = K2);
  6. K1 path: request 1 again with ``comp_smoother="scan"`` (K1), held
     against the K2 render;
  7. profile: request 2 once more under ``torch.profiler``, the card's busy
     share and its largest kernels.

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
WINDOW = 262144  # the serving analysis window
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

    def record(name, shape, err, err64, fn, plain_fn, nbytes, flops, launches, reported):
        ms, plain_ms = time_ms(fn, flush), time_ms(plain_fn, flush)
        call_ms = time_ms(fn, flush, hide_host=False)
        bound_ms = max(nbytes / rate, flops / FP32_RATE[form]) * 1e3
        by = "bytes" if nbytes / rate >= flops / FP32_RATE[form] else "operations"
        line(f"[kernels] {name} {shape}: max_abs_err {err:.3g}"
             f" (vs float64: kernel {err64[0]:.3g}, plain {err64[1]:.3g})")
        line(f"[kernels] {name} {shape}: {ms:.4f} ms ({call_ms:.4f} ms a call with the host)"
             f" | plain {plain_ms:.4f} ms | bound {bound_ms * 1e3:.1f} us ({by}) | {launches} launches")
        s = stats.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if reported:  # the track chain's shape, per-row alpha
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)

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

    k1, k2 = stats["onepole_core"], stats["compressor_fused_gain"]
    kernels = [
        dict(name="onepole_core", route="cuda", source="diffmst_torch/kernels/csrc/scan1p.cu",
             replaces="diffmst_tpu/kernels/scan1p.py:111", launches=k1_launches,
             max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None),
        dict(name="compressor_fused_gain", route="cuda",
             source="diffmst_torch/kernels/csrc/comp_fused.cu",
             replaces="diffmst_tpu/kernels/comp_fused.py:98", launches=k2_launches,
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None),
    ]
    line(f"[serving] realtime factors {', '.join(f'{SONG_S / w:.1f}x' for w in walls)}"
         f" for {SONG_S:.0f} s, {N_TRACKS}-track songs")
    line(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
