#!/usr/bin/env python3
"""Serve and train the PyTorch port on one CUDA card, and check its kernels.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card and the CUDA toolkit (``nvcc``); it builds the
port's kernels from ``diffmst_torch/kernels/csrc`` into
``build/diffmst_torch_kernels/`` at first use. Phases:

  1. device: the card's name and power limit;
  2. build: every kernel, timed, with ptxas's registers and spills by
     kernel;
  3. kernels: K1 (one-pole scan; with a per-sample alpha, K4), K2 (fused
     compressor), K3 (release min-scan) and K5 (biquad cascade) at the
     serving shapes, and their backward kernels (K1's with a per-row and, as
     K4's, a per-sample alpha; K2's, with the envelope that K2's forward
     writes for it) at the training shapes, against their plain PyTorch
     versions, with times, achieved TB/s and bounds; K2, K1, K3, K4 and
     their backward kernels (one single-pass kernel each) also over 4 rows
     of 2^20 + 3 samples at a pole of 0.9998 (K4: per-sample poles within
     1e-5 of it) against float64, and one call of each traced with
     torch.profiler (one kernel and one memset a call);
     K5 also against scipy.signal.sosfilt in float64 at a 20 Hz
     high-Q low shelf, its time split by its three kernels (chunk, carry,
     apply; CUDA events), and the stages it writes for its backward
     against the plain version's; K5's backward at the track and master
     EQs' shapes, its time split by its four kernels (chunk, carry, apply,
     reduce); the "ballistics" smoother's kernel at 32 x 262,144 against
     its plain version, its backward (K4's backward kernel on the recorded
     coefficients) against the plain composition, its time beside two
     bounds (its bytes, and the latency of its dependent steps), one call
     traced (one kernel, no memset);
  4. reference: a small song rendered on the card and on the CPU (the
     kernels' plain versions) with the same weights;
  5. serving: three 60 s, 8-track requests through ``run_diffmst`` with the
     full-width model (``MixStyleTransferModel.build()``, random weights from
     a seeded generator) and ``AdvancedMixConsole`` (compressor "auto" = K2);
  6. K1 path: request 1 again with ``comp_smoother="scan"`` (K1), held
     against the K2 render;
  7. profile: request 2 once more under ``torch.profiler``, the card's busy
     share and its largest kernels;
  8. streaming: three requests with ``render_mode="streaming"`` and the
     causal console (``comp_smoother="decoupled"``, ``eq_method="scan"``:
     K3, K1 and K5), the seams of request 1 held against one render of the
     whole song (and against the "ola" render's), and a
     ``return_device=True`` call;
  9. training: the Method-1 step (``diffmst_torch.train.System``) at the
     reference recipe, batch 4 x 8 tracks x 262,144 samples: one step with
     "scan" (K1 forward and backward), whose gradients are held against
     the K2 path's on the same batch and seeded weights, then three steps
     with the compressor "auto" (K2 forward and backward); steps/s, audio
     seconds per second, peak memory and launches per step;
 10. training profile: one more step under ``torch.profiler``, the card's
     busy share, the time of the model, the console and the loss forward
     and backward, and the largest kernels;
 11. training-causal: two Method-1 steps with the causal console (K3, K1 and
     K5 forward and backward), and the console's gradients at the step's
     predicted parameters through the kernels against the same gradients
     through the plain versions on the card;
 12. cli: ``main_torch.py`` as a user runs it, each command a subprocess:
     a synthetic corpus (``scripts/make_synth_corpus_torch.py``, 4 + 1
     songs of 12 s), ``fit`` of 3 steps at full width on the shipped
     configs (K2), a resume to step 6, ``validate`` and ``predict``; their
     steps/s, buffer reloads, checkpoint bytes and seconds, peak memory;
     the parts of each command's model build; then the fit's three steps
     through ``main_torch.main`` in this process, whose K2 and K2-bwd
     launches it counts;
 13. feature-loss: at full width, three Method-1 steps with
     ``AudioFeatureLoss`` (its terms and gradient on one batch held against
     the CPU's), three Method-2 steps on stereo reference mixes, two
     knowledge-engineering (KE) steps with the fx bus (the reverb at
     65,536 samples, 1,023 taps; KE's host milliseconds), each counting
     its K2 and K2-bwd launches; a 60 s, 8-track request with the fx bus,
     "ola" and "streaming" (realtime factor, seam distance); and
     ``main_torch.py fit`` on ``naive.yaml`` + ``unpaired+feat.yaml`` over
     [cli]'s corpus and synthetic reference mixes, a subprocess;
 14. param-est: parameter-estimation pretraining at full width: a
     ``MixDataModule`` batch of 4 x 2 x 262,144 (synthetic mixes and a
     silent file), HPSS on the card against the CPU's float64, the
     ``Remixer`` (2 K2 launches and no K2-bwd a remix) against the kernels'
     plain versions, three ``ParameterEstimationSystem`` steps (steps/s,
     peak memory) and ``eval_step``, HDemucs at HDEMUCS_HIGH on synthetic
     weights (a batch's forward, a clip against the CPU, a step with it as
     the separator), and ``scripts/param_est_demo_torch.py 20 4``, a
     subprocess;
 15. eval: evaluation and serving at full width: two 60 s, 8-track songs
     (``scripts/make_eval_songs_torch.py``), ``scripts/
     eval_all_combo_torch.py`` over them (16 CSV rows; one upload a song, 12
     K2 launches a request; a request again with the track cache cleared,
     bitwise equal), 20 iterations of ``scripts/online_torch.py::
     optimize_params`` (K2 and K2-bwd; 3 held against the plain versions),
     ``main_torch.py export`` as a subprocess, and a fresh process that
     loads the export without the model's code and serves a song with
     ``run_exported`` (6 K2 launches traced, against ``run_diffmst``'s
     mix), then ``scripts/eval_listen_torch.py`` and ``scripts/
     run_torch.py``;
 16. tpu-recipe: ``configs/models/naive+tpu.yaml`` at full width (bf16
     compute, Adam's first moment in bf16) built through
     ``main_torch.build_from_config``: the dtypes, the bf16 model against
     its float32 twin (0.05), one step's console cotangents through K2 and
     K2-bwd against the plain versions, 3 timed steps, a step each with
     encoder remat and the first two Cnn14 blocks' remat (the running
     statistics against a plain step's), a flattened-optimizer update
     against the per-leaf one, a 60 s request with the bf16 model, and
     ``main_torch.py fit`` and a resume on the recipe over [cli]'s corpus
     (subprocesses; the checkpoint's first moment bf16);
 17. observe: a ``Trainer.fit`` of 3 steps at full width over [cli]'s
     corpus with ``profile_steps=range(1, 2)``, ``LogAudioCallback`` and
     ``LogReferenceMix`` (the trace read by ``utils/trace_ops.py``: K2,
     K2-bwd and the ``system.*`` ranges; the callbacks' files), two
     Method-1 steps with ``comp_smoother="ballistics"`` (the ballistics
     kernel and K4-bwd; the console's gradients against the plain
     versions'), ``device_timer`` and ``Meter`` on a K2 call, and
     ``scripts/{compare,datasets,info,unet_separator_demo}_torch.py`` as
     subprocesses;
 18. fused: ``trainer.fused_steps`` (``diffmst_torch/train/fused.py``): at
     full width, for ``naive.yaml`` and ``naive+tpu.yaml``, the learning
     rate on a cosine over 16 steps and cuDNN deterministic, 8 eager
     Method-1 steps twice from one snapshot, then the warm-up group and the
     capture of a CUDA graph of 4 steps, then 2 replays from the same
     snapshot, held against the eager steps (losses, parameters, BatchNorm
     statistics, moments, generator, counters); sequential and fused
     steps/s, the capture and instantiation times, peak memory; one replay
     traced (K2 and K2-bwd counted from the card's records, the busy
     share); then ``main_torch.py fit`` on ``naive+tpu.yaml`` with
     ``trainer.fused_steps: 4`` over [cli]'s corpus, a subprocess; where
     the device decides which steps update, the same checks for
     (f) ``naive.yaml`` with ``skip_nonfinite_updates: 2`` and a NaN in
     group 2 (one replay traced, its steps/s and busy share against
     ``naive.yaml``'s) and (g) ``naive+tpu.yaml`` with
     ``accumulate_grad_batches: 3`` over three replays (offsets 0, 1, 2),
     and (h) ``naive+tpu.yaml`` groups of 4 x 8 x 262,144, then 131,072,
     then 262,144 again, two graphs sharing one pool (its growth printed),
     the replays held against eager steps bitwise;
 19. mesh: the device mesh (``diffmst_torch/parallel``) on the one card: a
     single-process step at the reference recipe, then two ranks over gloo
     (``parallel.launch``) at dp = 2 and at dp = 1 x mp = 2, each rank's
     step held against it (loss, grad_norm, gradients, BatchNorm running
     statistics) with 4 K2 and 2 K2-bwd launches a step in each rank, and
     steps/s and peak memory a rank; ``main_torch.py fit`` with
     ``trainer.devices: 2`` refused with JAX's message; a one-rank NCCL
     ``trainer.mesh: {dp: 1}`` fit with ``fused_steps: 4`` against the fit
     without the mesh;
 20. convergence: the demo scripts' recipes at full width
     (``scripts/{train_demo,probe_floor,train_demo_method2,
     train_demo_16track}_torch.py``): ``naive+tpu.yaml`` on 4 x 8 x 262,144
     stems synthesized on the card every step, the untrained probe on 4
     held-out batches, one epoch of 150 steps at lr 1e-5, the probe again,
     below the untrained one and the equal-gain-sum baseline; the oracle
     floors of the same probe set; Method 2 with ``AudioFeatureLoss`` and
     an accumulation of 2, two replays of 6 steps, and 16 tracks with padded
     slots and the fx bus, one replay of 8, each against eager steps from
     one snapshot (cuDNN's and PyTorch's deterministic kernels); their K2
     and K2-bwd launches.

Every check raises on failure. The line before the last is a JSON object
with one entry per kernel; the last line is the result JSON. Float32
matrix products and convolutions run without TF32, here and in
``main_torch.py`` (``diffmst_torch.utils.device.use_full_float32``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SR = 44100.0
WINDOW = 262144  # the serving analysis window and the training example length
HALF = WINDOW // 2  # the training step renders and differentiates one half
SONG_S = 60.0
N_TRACKS = 8
REPEATS = 20

# Peak device-memory rates (bytes/s), and float32 and float64 rates outside
# the tensor cores (FLOP/s), of an H100, by form factor (NVIDIA data sheets).
HBM_RATE = {"sxm": 3.35e12, "pcie": 2.0e12}
FP32_RATE = {"sxm": 67e12, "pcie": 51e12}
FP64_RATE = {"sxm": 34e12, "pcie": 26e12}


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
    from diffmst_torch.utils.device import use_full_float32

    use_full_float32()  # the port's precision, as main_torch.py sets it
    line("[device]", name, "| count", torch.cuda.device_count())
    line("[device] nvidia-smi:", smi)
    line("[device] tf32 off: cudnn.allow_tf32 =", torch.backends.cudnn.allow_tf32,
         "matmul.allow_tf32 =", torch.backends.cuda.matmul.allow_tf32)
    form = "pcie" if "pcie" in (name + smi).lower() else "sxm"
    return name, smi, form


def _kernel_names(mangled: list[str]) -> list[str]:
    """Short names of mangled kernel names (``scan_tiles<OnepoleTileOp,
    true>``), by the toolkit's cu++filt; the mangled ones where it is
    missing."""
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt is None:
        return mangled
    out = subprocess.run([filt], input="\n".join(mangled), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(mangled):
        return mangled
    names = []
    for n in out:
        n = n.replace("(anonymous namespace)::", "").replace("diffmst::", "")
        n = re.sub(r"^void ", "", n)
        depth, cut = 0, len(n)
        for i, ch in enumerate(n):  # drop the parameter list after the template arguments
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                cut = i
                break
        names.append(n[:cut])
    return names


def phase_build():
    from diffmst_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_kernels()
    line(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for src, log in sorted(_build.build_log.items()):
        kernels, current = [], None  # [mangled name, registers, spills]
        for ln in log.splitlines():
            if "Function properties for " in ln:
                current = [ln.split("Function properties for ")[1].strip(), "", ""]
                kernels.append(current)
            elif current is not None and "spill" in ln:
                current[2] = ln.strip()
            elif current is not None and "registers" in ln:
                current[1] = ln.split("Used ")[-1].strip()
        for name, (_, regs, spills) in zip(_kernel_names([k[0] for k in kernels]), kernels):
            line(f"[build] {src}: {name[:90]}: {regs}; {spills}")


def _static_gain_db(x, thr, ratio, knee):
    """The compressor's soft-knee gain in dB, (B, T), from audio x."""
    from diffmst_torch.ops.compressor import _static_gain_db as gain

    x_db = 20.0 * torch.log10(torch.clamp(x.abs(), min=1e-8))
    return gain(x_db, thr[:, None], ratio[:, None], knee[:, None])


SPIN_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep
SPIN_LEAD = 64  # spin kernels ahead of a traced call, times 4 on each retake


def device_ops(fn, attempts: int = 3) -> dict:
    """The kernel launches, memsets and copies that one call of ``fn`` puts
    on the card, from a torch.profiler trace of that call: the card's
    records of them, and the runtime calls that enqueued them. A trace
    begun some seconds after the last one ended can lose the first few
    records of the card's activity while keeping every runtime call (on an
    H100: 1 to 4 of them, more as the process ages; a lone kernel's trace
    comes back empty, a memset and a kernel as the kernel alone;
    ``scripts/trace_probe_torch.py``). So ``SPIN_LEAD`` spin kernels run
    first in the window, finished before the call, and are left out of
    both counts. A trace whose two counts differ is taken again with four
    times the lead, up to ``attempts`` in all; the card's records are the
    answer."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    kinds = (("kernels", "cudaLaunchKernel"), ("memsets", "cudaMemset"), ("copies", "cudaMemcpy"))
    for trace in range(1, attempts + 1):
        lead = SPIN_LEAD * 4 ** (trace - 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        names = [e.name for e in events if e.device_type == cuda and SPIN_KERNEL not in e.name]
        calls = [e.name for e in events if e.device_type != cuda]
        memsets = sum(n.startswith("Memset") for n in names)
        copies = sum(n.startswith("Memcpy") for n in names)
        device = dict(kernels=len(names) - memsets - copies, memsets=memsets, copies=copies)
        runtime = {k: sum(c.startswith(prefix) for c in calls) for k, prefix in kinds}
        runtime["kernels"] -= lead  # the spin kernels' launches
        if device == runtime:
            break
        line(f"[kernels] trace {trace} of {attempts} ({lead} spin kernels first): the card's records"
             f" {device} differ from the runtime calls {runtime}")
    return dict(device, names=[n[:60] for n in names], runtime=runtime, traces=trace)


def phase_kernels(form: str):
    """K1, K2, K3 and K5 against their plain versions at the serving shapes,
    and their backward kernels at the training shapes."""
    from diffmst_torch.kernels import comp_fused, iir_fused, scan1p
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

    def record(name, shape, err, err64, fn, plain_fn, nbytes, flops, launches, reported, rel=None,
               flop_rate=FP32_RATE):
        """Times a kernel's wrapper and its plain version; the bound is the
        larger of the bytes over the memory rate and the operations over
        ``flop_rate`` (float32, or float64 where the work is float64)."""
        ms, plain_ms = time_ms(fn, flush), time_ms(plain_fn, flush)
        call_ms = time_ms(fn, flush, hide_host=False)
        bound_ms = max(nbytes / rate, flops / flop_rate[form]) * 1e3
        by = "bytes" if nbytes / rate >= flops / flop_rate[form] else "operations"
        if err64 is not None:
            line(f"[kernels] {name} {shape}: max_abs_err {err:.3g}"
                 f" (vs float64: kernel {err64[0]:.3g}, plain {err64[1]:.3g})")
        else:
            line(f"[kernels] {name} {shape}: max_abs_err {err:.3g}, max relative error "
                 + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
        line(f"[kernels] {name} {shape}: {ms:.4f} ms ({call_ms:.4f} ms a call with the host),"
             f" {nbytes / ms / 1e9:.3f} TB/s | plain {plain_ms:.4f} ms | bound {bound_ms * 1e3:.1f} us"
             f" ({by}) | {launches} launches")
        s = stats.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": None})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if rel:
            s["max_rel_err"] = max(s["max_rel_err"] or 0.0, *rel.values())
        if reported:  # the track chain's shape
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, shape=shape,
                     achieved_tb_s=nbytes / ms / 1e9)

    def traced(name, shape, fn, memsets=1):
        """Requires one call of a single-pass kernel's wrapper to put one
        kernel launch and ``memsets`` memsets (its scratch's), and no copy,
        on the card."""
        ops = device_ops(fn)
        line(f"[kernels] {name} {shape}, one call traced (torch.profiler, trace {ops['traces']}):"
             f" {ops['kernels']} kernel launches, {ops['memsets']} memsets, {ops['copies']} copies"
             f" ({'; '.join(ops['names'])}); the runtime calls that enqueued them {ops['runtime']}")
        require((ops["kernels"], ops["memsets"], ops["copies"]) == (1, memsets, 0),
                f"one {name} call is one kernel and {memsets} memsets ({ops})")
        stats[name].update(cuda_launches_per_call=ops["kernels"], memsets_per_call=ops["memsets"])

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
        scan1p.onepole_core.launches = scan1p.onepole_core.launches_per_sample = 0
        y = scan1p.onepole_core(b, a)
        torch.cuda.synchronize()
        launches = scan1p.onepole_core.launches_per_sample if per_sample else scan1p.onepole_core.launches
        y_plain = scan1p.onepole_core_plain(b, a)
        err = (y - y_plain).abs().max().item()
        err64 = vs64(y, y_plain, scan1p.onepole_core_plain(b.double(), a.double()))
        require(bool(torch.isfinite(y).all()), "K1 output finite")
        require(launches == 1, f"one K1 launch ({launches})")
        require(err <= 1e-3, f"K1 {rows}x{WINDOW} agrees with its plain version in dB ({err})")
        n = rows * WINDOW
        nbytes = n * (12 if per_sample else 8) + (0 if per_sample else rows * 4)
        shape = f"{rows}x{WINDOW}" + (" alpha/sample" if per_sample else "")
        record("onepole_core_per_sample" if per_sample else "onepole_core", shape, err, err64,
               lambda: scan1p.onepole_core(b, a), lambda: scan1p.onepole_core_plain(b, a),
               nbytes, 2 * n, launches, rows == 32)
        if per_sample:  # K4's single-pass kernel
            traced("onepole_core_per_sample", shape, lambda: scan1p.onepole_core(b, a))

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
        if rows == 32:  # the single-pass kernels
            traced(name, shape, lambda: bwd(dy, a, y))

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

    # K2 and its backward over 4 x (2^20 + 3) samples (257 and 513 tiles a row, the
    # rows' starts off 16 bytes) at alpha 0.9998, a 250 ms attack, against
    # the plain versions in float64: the look-back's carries over a long row
    rows, t = 4, 2**20 + 3
    x = torch.randn(rows, t, device=dev, generator=gen) * torch.linspace(0.02, 1.0, t, device=dev)
    x = x / x.abs().amax(dim=-1, keepdim=True)
    xd = torch.roll(x, 1024, dims=-1)
    thr, ratio, _, knee, makeup = params(rows)
    alpha = torch.full((rows,), 0.9998, device=dev)
    p = comp_fused._param_rows(thr, ratio, knee, alpha, makeup).contiguous()
    out, env = comp_fused._launch(x, xd, p, 1e-8, envelope=True)
    dy = torch.randn(rows, t, device=dev, generator=gen)
    got = comp_fused.compressor_fused_backward(x, xd, p, env, dy)
    torch.cuda.synchronize()
    out64, env64 = comp_fused._forward_plain(x.double(), xd.double(), p.double(), 1e-8)
    want = comp_fused.compressor_fused_backward_plain(*(v.double() for v in (x, xd, p, env, dy)))
    long_err = {"out": abs_err([(out, out64)]), "envelope": abs_err([(env, env64)]),
                "dx": rel_err(got[0], want[0]), "dx_delayed": rel_err(got[1], want[1]),
                "sums": max(rel_err(got[2][k], want[2][k]) for k in range(5))}
    line(f"[kernels] compressor_fused_gain and its backward {rows}x{t}, alpha 0.9998, against"
         f" float64: out {long_err['out']:.3g}, envelope {long_err['envelope']:.3g} dB (max-abs);"
         f" dx {long_err['dx']:.3g}, dx_delayed {long_err['dx_delayed']:.3g},"
         f" sums {long_err['sums']:.3g} (of their max-abs)")
    require(long_err["out"] <= 1e-5 and long_err["envelope"] <= 1e-5,
            f"K2 over 257 tiles a row agrees with float64 ({long_err})")
    require(long_err["dx"] <= 1e-5 and long_err["dx_delayed"] <= 1e-5 and long_err["sums"] <= 1e-4,
            f"K2's backward over 513 tiles a row agrees with float64 ({long_err})")
    del x, xd, out, env, dy, got, out64, env64, want

    # What one call of K2 (with and without the envelope) and of its backward
    # puts on the card at the track chain's shapes, counted in a trace of
    # that call: the look-back kernel and the memset of its scratch
    x = audio(32)
    xd = torch.roll(x, 2048, dims=-1)
    thr, ratio, attack, knee, makeup = params(32)
    p = comp_fused._param_rows(thr, ratio, knee, _ballistics_coeff(attack, SR), makeup).contiguous()
    xh, xdh = x[:, :HALF].contiguous(), xd[:, :HALF].contiguous()
    _, env = comp_fused._launch(xh, xdh, p, 1e-8, envelope=True)
    dy = torch.randn(32, HALF, device=dev, generator=gen)
    calls = {
        ("compressor_fused_gain", f"32x{WINDOW}"):
            lambda: comp_fused._launch(x, xd, p, 1e-8, envelope=False),
        ("compressor_fused_gain", f"32x{HALF} writing the envelope"):
            lambda: comp_fused._launch(xh, xdh, p, 1e-8, envelope=True),
        ("compressor_fused_backward", f"32x{HALF}"):
            lambda: comp_fused.compressor_fused_backward(xh, xdh, p, env, dy),
    }
    for (name, shape), fn in calls.items():
        traced(name, shape, fn)
    del x, xd, xh, xdh, env, dy

    # K3: the release stage on the detector's and the knee's gains of
    # synthetic audio, releases of 10-250 ms
    def release(rows, t):
        thr, ratio, _, knee, _ = params(rows)
        g = _static_gain_db(audio(rows)[:, :t], thr, ratio, knee).contiguous()
        ms = 10.0 + 240.0 * torch.rand(rows, device=dev, generator=gen)
        return g, _ballistics_coeff(ms, SR).contiguous()

    for rows in (32, 8):
        g, a = release(rows, WINDOW)
        scan1p.release_min_scan.launches = 0
        y = scan1p.release_min_scan(g, a)
        torch.cuda.synchronize()
        y_plain = scan1p.release_min_scan_plain(g, a)
        err = (y - y_plain).abs().max().item()
        err64 = vs64(y, y_plain, scan1p.release_min_scan_plain(g.double(), a.double()))
        require(bool(torch.isfinite(y).all()), "K3 output finite")
        require(err <= 1e-4, f"K3 {rows}x{WINDOW} agrees with its plain version in dB ({err})")
        n = rows * WINDOW
        # read g, write y; per sample (1 - a) g, a y + d and the min: 5 operations
        record("release_min_scan", f"{rows}x{WINDOW}", err, err64,
               lambda: scan1p.release_min_scan(g, a), lambda: scan1p.release_min_scan_plain(g, a),
               n * 8 + rows * 4, 5 * n, scan1p.release_min_scan.launches, rows == 32)

    # K1 (a row's alpha), K3, K4 (a per-sample alpha) and their backward
    # kernels over 4 x (2^20 + 3) samples (257 tiles a row at 4,096, the
    # rows' starts off 16 bytes) at alpha 0.9998 (K4: within 1e-5 of it,
    # sample by sample), against the plain versions in float64: the
    # look-back's carries over a long row
    rows, t = 4, 2**20 + 3
    x = torch.randn(rows, t, device=dev, generator=gen) * torch.linspace(0.02, 1.0, t, device=dev)
    thr, ratio, _, knee, _ = params(rows)
    g = _static_gain_db(x / x.abs().amax(dim=-1, keepdim=True), thr, ratio, knee).contiguous()
    alpha = torch.full((rows,), 0.9998, device=dev)
    b = ((1.0 - alpha)[:, None] * g).contiguous()
    dy = torch.randn(rows, t, device=dev, generator=gen)
    a4 = 0.9998 * (1.0 - 1e-5 * torch.rand(rows, t, device=dev, generator=gen))
    b4 = ((1.0 - a4) * g).contiguous()
    y1, y3, y4 = scan1p.onepole_core(b, alpha), scan1p.release_min_scan(g, alpha), scan1p.onepole_core(b4, a4)
    bwd1 = scan1p.onepole_core_backward(dy, alpha, y1)
    bwd3 = scan1p.release_min_scan_backward(dy, g, alpha, y3)
    bwd4 = scan1p.onepole_core_backward(dy, a4, y4)
    torch.cuda.synchronize()
    d64 = [v.double() for v in (dy, alpha, g, y1, y3, a4, y4)]
    want1 = scan1p.onepole_core_backward_plain(d64[0], d64[1], d64[3])
    want3 = scan1p.release_min_scan_backward_plain(d64[0], d64[2], d64[1], d64[4])
    want4 = scan1p.onepole_core_backward_plain(d64[0], d64[5], d64[6])
    long_err = {"K1": rel_err(y1, scan1p.onepole_core_plain(b.double(), alpha.double())),
                "K3": rel_err(y3, scan1p.release_min_scan_plain(g.double(), alpha.double())),
                "K1-bwd db": rel_err(bwd1[0], want1[0]), "K3-bwd dg": rel_err(bwd3[0], want3[0])}
    sums_err = {"K1-bwd dalpha": rel_err(bwd1[1], want1[1]), "K3-bwd dalpha": rel_err(bwd3[1], want3[1])}
    k4_err = {"K4": rel_err(y4, scan1p.onepole_core_plain(b4.double(), d64[5])),
              "K4-bwd db": rel_err(bwd4[0], want4[0]), "K4-bwd dalpha": rel_err(bwd4[1], want4[1])}
    line(f"[kernels] onepole_core (a row's and a per-sample alpha), release_min_scan and their"
         f" backward kernels {rows}x{t}, alpha 0.9998, against float64 (of their max-abs): "
         + ", ".join(f"{k} {v:.3g}" for k, v in {**long_err, **sums_err, **k4_err}.items()))
    require(all(bool(torch.isfinite(v).all()) for v in (y1, y3, y4, *bwd1, *bwd3, *bwd4)),
            "K1, K3, K4 and their backward kernels' long rows finite")
    require(max(long_err.values()) <= 1e-5,
            f"K1, K3 and their backward kernels over 257 tiles a row agree with float64 ({long_err})")
    require(max(sums_err.values()) <= 1e-4, f"their dalpha row sums agree with float64 ({sums_err})")
    require(max(k4_err.values()) <= 1e-6,
            f"K4 and its backward over 257 tiles a row agree with float64 ({k4_err})")
    del x, g, b, dy, a4, b4, y1, y3, y4, bwd1, bwd3, bwd4, d64, want1, want3, want4

    # What one call of K1 (a row's alpha) and of K3 puts on the card at the
    # track chain's shape, counted in a trace of that call
    g, a3 = release(32, WINDOW)
    a1 = _ballistics_coeff(params(32)[2], SR).contiguous()
    b = ((1.0 - a1)[:, None] * g).contiguous()
    traced("onepole_core", f"32x{WINDOW}", lambda: scan1p.onepole_core(b, a1))
    traced("release_min_scan", f"32x{WINDOW}", lambda: scan1p.release_min_scan(g, a3))
    del g, b

    # K3's backward at the training shapes, on its own forward's output
    bwd = scan1p.release_min_scan_backward
    for rows in (32, 8):
        g, a = release(rows, HALF)
        y = scan1p.release_min_scan(g, a)
        dy = torch.randn(rows, HALF, device=dev, generator=gen)
        bwd.launches = 0
        dg, da = bwd(dy, g, a, y)
        torch.cuda.synchronize()
        dg_p, da_p = scan1p.release_min_scan_backward_plain(dy, g, a, y)
        rel = {"dg": rel_err(dg, dg_p), "dalpha": rel_err(da, da_p)}
        require(bool(torch.isfinite(dg).all() and torch.isfinite(da).all()), "K3 backward finite")
        require(bwd.launches == 1, f"one K3 backward launch ({bwd.launches})")
        require(rel["dg"] <= 1e-5, f"K3 backward dg agrees with its plain version ({rel['dg']})")
        require(rel["dalpha"] <= 1e-4, f"K3 backward dalpha agrees with its plain version ({rel['dalpha']})")
        n = rows * HALF
        # read dy, y, g, write dg; alpha and its sum 8 bytes a row. Per
        # sample the two branch tests, the scan (2), dg and the sum (3)
        record("release_min_scan_backward", f"{rows}x{HALF}", abs_err(((dg, dg_p), (da, da_p))), None,
               lambda: bwd(dy, g, a, y), lambda: scan1p.release_min_scan_backward_plain(dy, g, a, y),
               n * 16 + rows * 8, 7 * n, bwd.launches, rows == 32, rel)
        if rows == 32:
            traced("release_min_scan_backward", f"32x{HALF}", lambda: bwd(dy, g, a, y))

    # K5: the console's six-band EQ, parameters drawn over its ranges
    for rows in (32, 8):
        b, a = eq_sections(rows, gen)
        x = audio(rows).contiguous()
        iir_fused.sosfilt.launches = 0
        y = iir_fused.sosfilt(x, b, a)
        torch.cuda.synchronize()
        y_plain = iir_fused.sosfilt_plain(x, b, a)
        rel = {"y": rel_err(y, y_plain)}
        require(bool(torch.isfinite(y).all()), "K5 output finite")
        require(rel["y"] <= 1e-5, f"K5 {rows}x{WINDOW} agrees with its plain version ({rel})")
        n = rows * WINDOW
        # read x, write y, 30 coefficients a row; per sample and section the
        # TDF-II recurrence and output in float64: 9 operations, 54 in all
        record("sosfilt", f"{rows}x{WINDOW}", (y - y_plain).abs().max().item(), None,
               lambda: iir_fused.sosfilt(x, b, a), lambda: iir_fused.sosfilt_plain(x, b, a),
               n * 8 + rows * 120, 54 * n, iir_fused.sosfilt.launches, rows == 32, rel,
               flop_rate=FP64_RATE)
        split = sosfilt_passes(x, iir_fused._coef_rows(b, a), flush)
        line(f"[kernels] sosfilt {rows}x{WINDOW} by pass (CUDA events, median of {REPEATS}):"
             + ", ".join(f" {k} {v:.4f} ms" for k, v in split.items()))
        if rows == 32:
            stats["sosfilt"]["pass_ms"] = split
    line("[kernels] sosfilt moves 12 bytes a sample (x read twice, y written; 32 with the five"
         " stages a differentiated forward writes) in three launches; the bound counts 8")

    # K5 at the console's lowest, sharpest low shelf, against scipy in float64
    import scipy.signal

    b, a = eq_sections(4, gen, low_shelf_hz=20.0)
    x = audio(4).contiguous()
    y = iir_fused.sosfilt(x, b, a).double().cpu().numpy()
    sos = torch.cat([b, a], dim=-1).double().cpu().numpy()
    x64 = x.double().cpu().numpy()
    ref = np.stack([scipy.signal.sosfilt(sos[i], x64[i]) for i in range(4)])
    radius = max(float(np.abs(np.roots(sos[i, 0, 3:])).max()) for i in range(4))
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    line(f"[kernels] sosfilt 4x{WINDOW}, low shelf at 20 Hz, Q 5, +12 dB (pole radius {radius:.6f}):"
         f" {err:.3g} of the peak off scipy.signal.sosfilt in float64")
    require(err <= 1e-4, f"K5 agrees with scipy at a 20 Hz shelf ({err})")
    stats["sosfilt"]["scipy_rel_err"] = err

    # K5's backward at the training shapes: the track EQ's 32 rows and the
    # master EQ's 8, on the stages of the kernel's own forward
    bwd = iir_fused.sosfilt_backward
    for rows in (32, 8):
        b, a = eq_sections(rows, gen)
        coef = iir_fused._coef_rows(b, a)
        x = audio(rows)[:, :HALF].contiguous()
        y, stages = iir_fused._launch(x, coef)
        if rows == 32:
            y_p, stages_p = iir_fused._forward_plain(x, coef)
            rel = {"y": rel_err(y, y_p), "stages": rel_err(stages, stages_p)}
            require(stages.shape == (5, 32, HALF), f"K5 keeps five stages ({tuple(stages.shape)})")
            require(max(rel.values()) <= 1e-5,
                    f"K5's stages at 32x{HALF} agree with the plain version's ({rel})")
            ms = time_ms(lambda: iir_fused._launch(x, coef), flush)
            line(f"[kernels] sosfilt 32x{HALF} with its five stages: {ms:.4f} ms, max relative error "
                 + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
            stats["sosfilt"]["stages_rel_err"] = rel["stages"]
            stats["sosfilt"]["ms_with_stages_32x131072"] = ms
        dy = torch.randn(rows, HALF, device=dev, generator=gen)
        bwd.launches = 0
        dx, dcoef = bwd(x, stages, y, coef, dy)
        torch.cuda.synchronize()
        dx_p, dcoef_p = iir_fused.sosfilt_backward_plain(x, stages, y, coef, dy)
        rel = {"dx": rel_err(dx, dx_p), "dcoef": max(rel_err(dcoef[s, k], dcoef_p[s, k])
                                                    for s in range(6) for k in range(5))}
        require(bool(torch.isfinite(dx).all() and torch.isfinite(dcoef).all()), "K5 backward finite")
        require(bwd.launches == 1, f"one K5 backward launch ({bwd.launches})")
        require(rel["dx"] <= 1e-5, f"K5 backward dx agrees with its plain version ({rel['dx']})")
        require(rel["dcoef"] <= 1e-4, f"K5 backward's 30 sums a row agree with their plain versions ({rel})")
        n = rows * HALF
        # read x, the five stages, y and dy, write dx (36 bytes a sample), 30
        # coefficients and 30 sums a row; per sample and section the reversed
        # filter (9), w's recurrence (4) and five sums (10) in float64
        record("sosfilt_backward", f"{rows}x{HALF}", abs_err(((dx, dx_p),)), None,
               lambda: bwd(x, stages, y, coef, dy),
               lambda: iir_fused.sosfilt_backward_plain(x, stages, y, coef, dy),
               n * 36 + rows * 240, 6 * 23 * n, bwd.launches, rows == 32, rel, flop_rate=FP64_RATE)
        split = sosfilt_backward_passes(x, stages, y, coef, dy, flush)
        line(f"[kernels] sosfilt_backward {rows}x{HALF} by pass (CUDA events, median of {REPEATS}):"
             + ", ".join(f" {k} {v:.4f} ms" for k, v in split.items()))
        if rows == 32:
            stats["sosfilt_backward"]["pass_ms"] = split
    line("[kernels] sosfilt_backward moves 40 bytes a sample (dy read twice; x, the five stages and y"
         " once; dx written) in four launches; the bound counts 36")
    phase_ballistics(stats, form, flush, gen, params, audio, traced)
    return stats


def phase_ballistics(stats, form, flush, gen, params, audio, traced):
    """The "ballistics" smoother's kernel at 32 x 262,144, on the gains of
    audio whose level alternates every 50 ms (attack 1-20 ms, release
    50-300 ms), against its plain version: the forward in dB, then its
    backward (K4's backward kernel and elementwise operations, on the
    forward's recorded coefficients and branches) against the plain
    composition. Times: the kernel's median, the plain version's one call,
    and two bounds: its bytes over the memory rate, and the latency of its
    262,144 dependent steps (``ballistics_chain``, one thread, no memory)."""
    import importlib

    from diffmst_torch.ops.compressor import _ballistics_coeff

    smoother = importlib.import_module("diffmst_torch.kernels.smoother")
    dev = torch.device("cuda")
    rows, t = 32, WINDOW
    level = 0.05 + 0.95 * ((torch.arange(t, device=dev) // int(0.05 * SR)) % 2)
    thr, ratio, _, knee, _ = params(rows)
    g = _static_gain_db(audio(rows) * level, thr, ratio, knee).contiguous()
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(rows, device=dev, generator=gen)  # noqa: E731
    aa, ar = _ballistics_coeff(u(1.0, 20.0), SR).contiguous(), _ballistics_coeff(u(50.0, 300.0), SR).contiguous()
    smoother.ballistics.launches = 0
    y = smoother.ballistics(g, aa, ar)
    y_rec, a, attack = smoother._launch(g, aa, ar, record=True)
    torch.cuda.synchronize()
    launches = smoother.ballistics.launches
    stats["ballistics"] = {}
    traced("ballistics", f"{rows}x{t}", lambda: smoother.ballistics(g, aa, ar), memsets=0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    y_p, a_p, attack_p = smoother.ballistics_plain(g, aa, ar, record=True)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)  # one call: the plain loop takes seconds
    err = (y - y_p).abs().max().item()
    n_attack = int(attack.sum())
    line(f"[kernels] ballistics {rows}x{t}: max_abs_err {err:.3g} dB against the plain version;"
         f" the recording launch's output {'equal' if torch.equal(y_rec, y) else 'unequal'} to the other's;"
         f" branches: attack {n_attack}, release {attack.numel() - n_attack}, differing from the plain"
         f" version's {int((attack != attack_p).sum())}, coefficients differing {int((a != a_p).sum())}")
    require(bool(torch.isfinite(y).all()), "ballistics output finite")
    require(launches == 2, f"two ballistics launches ({launches})")
    require(err <= 1e-4, f"ballistics {rows}x{t} agrees with its plain version in dB ({err})")
    require(torch.equal(y_rec, y), "the recording launch writes the same output")
    require(min(n_attack, attack.numel() - n_attack) >= 1000, f"both branches taken ({n_attack})")

    bwd = importlib.import_module("diffmst_torch.kernels.scan1p").onepole_core_backward
    dy = torch.randn(rows, t, device=dev, generator=gen)
    bwd.launches_per_sample = 0
    got = smoother.ballistics_backward(dy, g, y, a, attack)
    torch.cuda.synchronize()
    want = smoother.ballistics_backward_plain(dy, g, y, a, attack)
    rel = {k: (u_.double() - w.double()).abs().max().item() / max(w.double().abs().max().item(), 1e-30)
           for k, u_, w in zip(("dg", "dalpha_a", "dalpha_r"), got, want)}
    line(f"[kernels] ballistics backward {rows}x{t} (K4's backward kernel, {bwd.launches_per_sample} launch,"
         f" and elementwise operations) against the plain composition, of each output's max-abs: "
         + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    require(all(bool(torch.isfinite(v).all()) for v in got), "ballistics backward finite")
    require(bwd.launches_per_sample == 1, f"the backward is one K4-bwd launch ({bwd.launches_per_sample})")
    require(rel["dg"] <= 1e-5, f"ballistics backward dg agrees with the plain composition ({rel})")
    require(max(rel["dalpha_a"], rel["dalpha_r"]) <= 1e-4,
            f"ballistics backward row sums agree with the plain composition ({rel})")

    ms = time_ms(lambda: smoother.ballistics(g, aa, ar), flush)
    rec_ms = time_ms(lambda: smoother._launch(g, aa, ar, record=True), flush)
    bwd_ms = time_ms(lambda: smoother.ballistics_backward(dy, g, y, a, attack), flush)
    chain_ms = smoother.chain_seconds(t, float(aa[0]), float(ar[0])) * 1e3
    n = rows * t
    # read g, write y; the two poles a row. Per sample the compare, the
    # select, the subtraction and the fused multiply-add in float64: 4
    nbytes, flops = n * 8 + rows * 8, 4 * n
    rate, fp64 = HBM_RATE[form], FP64_RATE[form]
    bound_ms = max(nbytes / rate, flops / fp64) * 1e3
    line(f"[kernels] ballistics {rows}x{t}: {ms:.4f} ms (recording the coefficients and branches"
         f" {rec_ms:.4f} ms; the composed backward {bwd_ms:.4f} ms) | plain {plain_ms:.1f} ms (one call)"
         f" | bounds: bytes {nbytes / rate * 1e6:.1f} us ({nbytes / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s),"
         f" operations {flops / fp64 * 1e6:.1f} us, the dependent steps' latency {chain_ms:.4f} ms"
         f" ({chain_ms * 1e6 / t:.2f} ns a step, one thread) | {ms / chain_ms:.2f}x the latency bound")
    stats["ballistics"].update(
        max_abs_err=err, max_rel_err=max(rel.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / rate >= flops / fp64 else "operations", shape=f"{rows}x{t}",
        achieved_tb_s=nbytes / ms / 1e9, latency_bound_ms=chain_ms, ms_recording=rec_ms, backward_ms=bwd_ms)


def pass_times(launch, names, flush) -> dict:
    """Device ms of each of a kernel's launches, the median over REPEATS
    calls, by CUDA events that ``launch(events)`` records before its first
    launch and after each, the L2 cache overwritten before each call."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    for e in events:
        e.record()  # creates the CUDA event
    times = []
    for _ in range(REPEATS + 1):
        flush.zero_()
        torch.cuda._sleep(20_000_000)  # the launches are enqueued before the card reaches them
        launch(events)
        events[-1].synchronize()
        times.append([events[k].elapsed_time(events[k + 1]) for k in range(len(names))])
    med = np.median(np.array(times[1:]), axis=0)
    return {k: float(v) for k, v in zip(names, med)}


def sosfilt_passes(x, coef, flush) -> dict:
    """Device ms of each of K5's three forward kernels (chunk, carry, apply),
    without stages."""
    from diffmst_torch.kernels import iir_fused

    return pass_times(lambda ev: iir_fused._launch(x, coef, keep_stages=False, events=ev),
                      ("chunk", "carry", "apply"), flush)


def sosfilt_backward_passes(x, stages, y, coef, dy, flush) -> dict:
    """Device ms of each of K5's four backward kernels (chunk, carry, apply,
    reduce)."""
    from diffmst_torch.kernels import iir_fused

    return pass_times(lambda ev: iir_fused._launch_backward(x, stages, y, coef, dy, events=ev),
                      ("chunk", "carry", "apply", "reduce"), flush)


def eq_sections(rows: int, gen: torch.Generator, low_shelf_hz: float | None = None):
    """(rows, 6, 3) sections of the console's EQ, parameters drawn over its
    ranges on the card; ``low_shelf_hz`` pins every low shelf there at the
    top Q (5) and +12 dB."""
    from diffmst_torch.console.ranges import advanced_param_ranges
    from diffmst_torch.ops.eq import _eq_sos

    dev = gen.device
    p = {k: lo + (hi - lo) * torch.rand(rows, device=dev, generator=gen)
         for k, (lo, hi) in advanced_param_ranges(SR)["parametric_eq"].items()}
    if low_shelf_hz is not None:
        for k, v in (("cutoff_freq", low_shelf_hz), ("q_factor", 5.0), ("gain_db", 12.0)):
            p[f"low_shelf_{k}"] = torch.full((rows,), v, device=dev)
    b, a = _eq_sos(SR, **p)
    return b.contiguous(), a.contiguous()


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


# --------------------------------------------------------------- streaming

CAUSAL = dict(comp_smoother="decoupled", eq_method="scan")


def whole_song_render(console, tracks, params, **console_kw):
    """One render of a whole song (a host array) on the card, with a
    request's predicted parameters (the kept tracks' rows, as run_diffmst
    scatters them) and its loudness gains: what seams are measured
    against."""
    from diffmst_torch.utils import inference

    tp, fp, mp = params
    keep, gains, _ = inference._gate(tracks[..., :WINDOW], SR)
    tp_full = torch.zeros(1, tracks.shape[1], tp.shape[-1], device="cuda")
    tp_full[0, keep] = tp[0]
    with torch.no_grad():
        stems = torch.from_numpy(tracks).cuda() * torch.from_numpy(gains).cuda()[None, :, None]
        return console(stems, tp_full, fp, mp, **console_kw).mix.cpu().numpy()


def phase_streaming(model):
    """Three requests with the seam-free overlap-save render and the causal
    console; the seams of request 1 against one render of the whole song."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.utils.inference import run_diffmst

    console = AdvancedMixConsole(SR, **CAUSAL)
    seen = {}

    def model_apply(t, r):  # the model, its normalized outputs kept for the seam check
        seen["params"] = model(t, r)
        return seen["params"]

    n = int(SONG_S * SR)
    walls, launches, first = [], [], None
    for i, (seed, fmt) in enumerate(((1, "float32"), (2, "float32"), (3, "pcm16"))):
        tracks, ref = synth_song(seed, N_TRACKS, SONG_S, quiet_track=N_TRACKS - 1)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mix, td, _, _ = run_diffmst(tracks, ref, model_apply, console, render_mode="streaming",
                                    output_format=fmt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        launches.append(counts)
        mf = mix.astype(np.float32) / (32767.0 if fmt == "pcm16" else 1.0)
        finite = bool(np.isfinite(mf).all())
        rms, peak = float(np.sqrt(np.mean(mf**2))), float(np.abs(mf).max())
        line(f"[streaming] request {i + 1} ({fmt}, {'cold' if i == 0 else 'warm'}): {walls[-1]:.3f} s,"
             f" {SONG_S / walls[-1]:.1f}x realtime, launches K3 {counts['K3']}, K1 {counts['K1']},"
             f" K5 {counts['K5']} (K2 {counts['K2']}), finite {finite}, rms {rms:.4g}, peak {peak:.4g}")
        require(mix.shape == (1, 2, n), f"streaming request {i + 1} mix shape {mix.shape}")
        require(finite and rms > 0.0, f"streaming request {i + 1} mix finite and not silent")
        require(counts["K3"] == counts["K1"] == counts["K5"] == 12 and counts["K2"] == 0,
                f"streaming request {i + 1}: 12 launches each of K3, K1 and K5, none of K2 ({counts})")
        require(td["compressor"]["ratio"].shape == (1, N_TRACKS - 1), "the quiet track was gated")
        if i == 0:
            first = (tracks, ref, mix, seen["params"])

    # Seams: request 1 against one render of the whole song with the same
    # predicted parameters, and the "ola" render's distance from it.
    tracks, ref, mix, params = first
    one = whole_song_render(console, tracks, params, use_fx_bus=False)
    ola, *_ = run_diffmst(tracks, ref, model, console, render_mode="ola")
    block = WINDOW // 2
    peak = float(np.abs(one).max())
    err_stream = float(np.abs(mix - one)[..., block:].max()) / peak
    err_ola = float(np.abs(ola - one)[..., block:].max()) / peak
    line(f"[streaming] seams of request 1 past its first block, against one render of the whole song:"
         f" streaming {err_stream:.3g} of the peak, ola {err_ola:.3g}")
    require(err_stream <= 1e-3, f"the streaming render agrees with the one-shot render ({err_stream})")
    require(err_stream <= 0.1 * err_ola, f"streaming is 10x closer than ola ({err_stream} vs {err_ola})")

    on_dev, *_ = run_diffmst(tracks, ref, model, console, render_mode="streaming", return_device=True)
    torch.cuda.synchronize()
    dev_err = float(np.abs(on_dev.cpu().numpy() - mix).max())
    line(f"[streaming] return_device: a {on_dev.dtype} tensor of shape {tuple(on_dev.shape)} on"
         f" {on_dev.device}, {dev_err:.3g} from request 1's host mix")
    require(on_dev.is_cuda and on_dev.shape == mix.shape, "return_device gives the mix on the card")
    require(dev_err <= 1e-6 * peak, f"return_device's mix equals the host mix ({dev_err})")
    return walls, launches


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


def reset_counts() -> None:
    from diffmst_torch.kernels import launch_counts, set_launch_counts

    set_launch_counts(dict.fromkeys(launch_counts(), 0))


def read_counts() -> dict:
    """Every kernel's launches since the last ``reset_counts``
    (``diffmst_torch.kernels.launch_counts``)."""
    from diffmst_torch.kernels import launch_counts

    return launch_counts()


def phase_training():
    """The Method-1 step at the reference recipe: a K1 step held against the
    K2 path at the seeded weights, then three timed K2 steps."""
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


    # The K1 step against the K2 path at the same weights, batch, reference
    # mix and BatchNorm statistics, with deterministic cuDNN, before the
    # timed steps: at the seeded weights the comparison is the same in every
    # run (after steps whose cuDNN backward is not deterministic it varied
    # from run to run, once to 4.4e-2 of the cotangents' norm: PERF.md,
    # Findings). Two K2 passes
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
    line(f"[training] the K1 step (scan), at the seeded weights: {k1_wall:.3f} s, loss {loss1:.5f},"
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
    del g1, g2, g2b, cot1, cot2  # 2.3 GB of gradient copies, out of the timed steps' peak memory

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

    per_step = sum(walls[1:]) / (len(walls) - 1)
    audio_s = TRAIN_BS * WINDOW / SR
    line(f"[training] steps 2-{TRAIN_STEPS}: {1.0 / per_step:.3f} steps/s ({per_step:.3f} s a step),"
         f" {audio_s / per_step:.1f} s of audio a second ({audio_s:.2f} s a step);"
         f" step 1 {walls[0]:.3f} s; peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    launches = {k: sum(c[k] for c in all_counts) + k1_counts[k] for k in all_counts[0]}
    return system, batch, flags, launches, 1.0 / per_step


def phase_train_profile(system, batch, flags, tag="train-profile"):
    """One more K2 step under torch.profiler. CUDA events recorded by hooks
    on the rendered mix and on the predicted parameters split the backward
    into the loss's, the console's and the model's. Returns its K2 and
    K2-bwd launches."""
    from torch.profiler import ProfilerActivity, profile

    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "bwd", "loss", "track", "master", "end", "opt")}
    reset_counts()
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
    counts = read_counts()
    require(np.isfinite(float(loss.detach())), "profiled step loss finite")
    el = lambda a, b: ev[a].elapsed_time(ev[b])  # noqa: E731
    console_end = "track" if el("track", "master") < 0 else "master"
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda and not e.key.startswith("system.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    line(f"[{tag}] one step traced: {wall:.3f} s wall, {busy_ms:.1f} ms of kernels and copies"
         f" on the card ({100.0 * busy_ms / (wall * 1e3):.1f}% busy)")
    for e in prof.events():
        if e.name.startswith("system.") and e.device_type != cuda:
            line(f"[{tag}] {e.name:18s} host {e.cpu_time_total / 1e3:8.1f} ms,"
                 f" card {e.device_time_total / 1e3:8.1f} ms")
    line(f"[{tag}] backward split by CUDA events: loss {el('bwd', 'loss'):.1f} ms,"
         f" console {el('loss', console_end):.1f} ms, model {el(console_end, 'end'):.1f} ms;"
         f" forward {el('start', 'bwd'):.1f} ms, optimizer {el('end', 'opt'):.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        line(f"[{tag}] {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x {e.key[:70]}")
    return counts


@contextlib.contextmanager
def plain_versions():
    """The console's K1, K2, K3, K5 and the ballistics kernel swapped for
    their plain versions, forward and backward, on the card: the console's
    modules call these names."""
    import importlib

    from diffmst_torch.kernels import comp_fused, iir_fused, scan1p

    comp_ops = importlib.import_module("diffmst_torch.ops.compressor")
    smoother = importlib.import_module("diffmst_torch.kernels.smoother")
    saved = (comp_ops.onepole_core, comp_ops.release_min_scan, comp_ops.compressor_fused_gain, iir_fused.sosfilt,
             comp_ops.ballistics)
    comp_ops.ballistics = lambda g, aa, ar: smoother._Ballistics.apply(g, aa, ar, True)
    comp_ops.onepole_core = lambda b, a: scan1p._Onepole.apply(b, a, True)
    comp_ops.release_min_scan = lambda g, a: scan1p._MinScan.apply(g, a, True)
    comp_ops.compressor_fused_gain = lambda x, xd, thr, ratio, knee, alpha, makeup, eps=1e-8: (
        comp_fused._Compressor.apply(x, xd, comp_fused._param_rows(thr, ratio, knee, alpha, makeup).contiguous(),
                                     eps, True))
    iir_fused.sosfilt = lambda x, b, a: iir_fused._Sosfilt.apply(x, iir_fused._coef_rows(b, a), True)
    try:
        yield
    finally:
        (comp_ops.onepole_core, comp_ops.release_min_scan, comp_ops.compressor_fused_gain, iir_fused.sosfilt,
         comp_ops.ballistics) = saved


def phase_training_causal():
    """Two Method-1 steps at the reference recipe with the causal console,
    then the console's gradients at the step's predicted parameters through
    the kernels against the same through the plain versions on the card."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    console = AdvancedMixConsole(SR, **CONSOLE_RANGES, **CAUSAL)
    system = System(model, console, MultiResolutionSTFTLoss(**MRSTFT), SystemConfig(),
                    generator=torch.Generator().manual_seed(1))
    batch = synth_batch(12)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = system.effect_flags(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, all_counts = [], []
    for step in range(2):
        reset_counts()
        t0 = time.perf_counter()
        m = system.train_step(batch, flags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        all_counts.append(counts)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        line(f"[training-causal] step {step + 1}: {walls[-1]:.3f} s, loss {loss:.5f}, grad_norm {gn:.5g},"
             f" launches {counts}")
        require(np.isfinite(loss) and np.isfinite(gn), f"causal step {step + 1} loss and grad_norm finite")
        require(int(m["pred_mix_nonfinite"]) == 0 and int(m["ref_mix_nonfinite"]) == 0,
                f"causal step {step + 1} mixes finite")
        require(all(counts[k] == 4 for k in ("K3", "K1", "K5"))
                and all(counts[k] == 2 for k in ("K3-bwd", "K1-bwd", "K5-bwd"))
                and counts["K2"] == counts["K2-bwd"] == 0,
                f"causal step {step + 1}: K3, K1, K5 4 launches each forward, 2 backward ({counts})")
    peak = torch.cuda.max_memory_allocated()
    audio_s = TRAIN_BS * WINDOW / SR
    line(f"[training-causal] step 2: {1.0 / walls[1]:.3f} steps/s ({walls[1]:.3f} s,"
         f" {audio_s / walls[1]:.1f} s of audio a second); step 1 {walls[0]:.3f} s;"
         f" peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")

    # The console's gradients at the predicted parameters, one fixed
    # cotangent on the mix (no loss whose L1 signs could flip).
    with torch.no_grad():
        _, _, out = system.forward(batch, flags, True)
    tp, fp, mp = (t.detach() for t in out["pred_params"])
    tracks_b = batch.tracks[..., HALF:]
    w = torch.randn(TRAIN_BS, 2, HALF, device="cuda", generator=torch.Generator("cuda").manual_seed(3))

    def console_grads():
        leaves = [t.clone().requires_grad_() for t in (tracks_b, tp, mp)]
        mix = console(leaves[0], leaves[1], fp, leaves[2], use_fx_bus=False).mix
        (mix * w).sum().backward()
        torch.cuda.synchronize()
        return [leaf.grad for leaf in leaves]

    reset_counts()
    got = console_grads()
    kernel_counts = read_counts()
    with plain_versions():
        reset_counts()
        want = console_grads()
        plain_counts = read_counts()
    rel = {name: float((g.double() - p.double()).norm() / p.double().norm())
           for name, g, p in zip(("tracks", "track_params", "master_params"), got, want)}
    line(f"[training-causal] console gradients at the predicted parameters, {TRAIN_BS}x{TRAIN_TRACKS}x{HALF},"
         f" kernels vs plain versions on the card, of each tensor's norm: "
         + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
         + f"; launches {kernel_counts} (plain pass {plain_counts})")
    require(all(kernel_counts[k] > 0 for k in ("K3-bwd", "K1-bwd", "K5-bwd")), "the kernels' gradients ran")
    require(not any(plain_counts.values()), f"the plain pass launched no kernel ({plain_counts})")
    require(max(rel.values()) <= 1e-4, f"the console's gradients agree with the plain versions' ({rel})")
    launches = {k: sum(c[k] for c in all_counts) for k in all_counts[0]}
    return launches


# ---------------------------------------------------------------- the CLI

CLI_CONFIGS = ("configs/config.yaml", "configs/optimizer.yaml", "configs/data/synthetic-8.yaml",
               "configs/models/naive.yaml")
CLI_SONGS = (4, 1, 12.0)  # train songs, val songs, seconds


def _run_cli(root: pathlib.Path, argv: list, what: str, timeout: float = 300.0):
    """Run ``python3 <argv>`` from the repository root, as a user types it;
    return (stdout, wall seconds). A non-zero exit raises with the end of
    its output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"check failed: {what} exited {proc.returncode} after {wall:.1f} s:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, wall


def _cli_numbers(out: str) -> dict:
    """What a CLI run printed: the [train] lines' steps/s, every logged loss,
    the buffer reloads, the checkpoints' bytes and seconds, peak memory."""
    num = r"([-+0-9.eEinfa]+)"
    return dict(
        steps_per_sec=[float(x) for x in re.findall(r"^\[train\] .*steps_per_sec=" + num, out, re.M)],
        train_epochs=[int(x) for x in re.findall(r"^\[train\] .*epoch=(\d+) ", out, re.M)],
        losses=[float(x) for x in re.findall(r"^\[\w+\] (?:.* )?loss=" + num, out, re.M)],
        reloads=[(subset, float(sec), native == "True") for subset, sec, native in re.findall(
            r"^data: (\w+) buffer reloaded: .* in " + num + r" s \(native loader: (\w+)\)", out, re.M)],
        saved=[(int(b), float(sec)) for b, sec in re.findall(
            r"^checkpoint: saved .* \((\d+) bytes\) in " + num + " s", out, re.M)],
        restored=[float(x) for x in re.findall(r"^checkpoint: restored .* in " + num + " s", out, re.M)],
        peak=[int(x) for x in re.findall(r"^peak card memory: (\d+) bytes", out, re.M)],
        tf32=re.findall(r"^device: .*TF32: cuDNN (\w+), matmul (\w+)", out, re.M),
        built=[float(x) for x in re.findall(r"^built: .* parameters in " + num + " s", out, re.M)],
        built_parts=[dict((k, float(v)) for k, v in re.findall(r"([a-z][a-z ]*) " + num + " s", parts))
                     for parts in re.findall(r"^built: .* s \((.*)\)$", out, re.M)],
        epoch_seconds=[float(x) for x in re.findall(r"^\[epoch\] .*epoch_seconds=" + num, out, re.M)],
    )


def phase_cli(root: pathlib.Path, tmp: pathlib.Path, training_steps_per_s: float) -> dict:
    """``main_torch.py`` as a user runs it, at full width: a synthetic corpus
    (``scripts/make_synth_corpus_torch.py``) under ``tmp``, then ``fit`` of
    3 steps on the shipped configs (``naive.yaml``'s 190.9 M parameters, the
    console's default "auto" = K2) with an overlay of the corpus paths and
    the epoch's size, a resume to step 6, ``validate`` and ``predict``, each
    a subprocess; then the fit's three steps in this process through
    ``main_torch.main``, with the kernel counts read around them. Returns
    those counts."""
    import yaml

    from diffmst_torch.data import read_audio

    corpus, ckpts = tmp / "corpus", tmp / "ckpts"
    _, corpus_s = _run_cli(root, ["scripts/make_synth_corpus_torch.py", str(corpus),
                                  *map(str, CLI_SONGS)], "make_synth_corpus_torch.py")
    data = {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
            "num_examples_per_pass": 12, "num_train_passes": 1}
    trainer = {"max_epochs": 1, "log_every_n_steps": 1, "num_sanity_val_steps": 1,
               "default_root_dir": str(ckpts)}

    def overlay(name, trainer_over=()):
        p = tmp / name
        p.write_text(yaml.safe_dump({"trainer": {**trainer, **dict(trainer_over)},
                                     "data": {"init_args": data}}))
        return [*(str(root / c) for c in CLI_CONFIGS), str(p)]

    def cmd(command, configs, *extra):
        return ["main_torch.py", command, *(a for c in configs for a in ("-c", c)), *extra]

    line(f"[cli] corpus: {CLI_SONGS[0]} train and {CLI_SONGS[1]} val songs of {CLI_SONGS[2]:.0f} s"
         f" ({sum(f.stat().st_size for f in corpus.rglob('*.wav'))} bytes of WAV) in {corpus_s:.1f} s")
    last = str(ckpts / "last")
    runs = {}
    for name, argv in (
        ("fit", cmd("fit", overlay("fit.yaml"))),
        ("resume", cmd("fit", overlay("resume.yaml", {"max_epochs": 2}), "--ckpt_path", last)),
        ("validate", cmd("validate", overlay("fit.yaml"), "--ckpt_path", last)),
        ("predict", cmd("predict", overlay("fit.yaml"), "--ckpt_path", last,
                        "--track_dir", str(corpus / "val_song00"),
                        "--ref", str(corpus / "val_song00" / "keys_st.wav"),
                        "--output", str(tmp / "pred.wav"))),
    ):
        out, wall = _run_cli(root, argv, f"main_torch.py {name}")
        runs[name] = n = _cli_numbers(out)
        require(all(np.isfinite(x) for x in n["losses"]), f"{name}: every logged loss finite ({n['losses']})")
        require(n["tf32"] == [("False", "False")], f"{name}: TF32 off ({n['tf32']})")
        line(f"[cli] {name}: exit 0 in {wall:.1f} s; [train] steps/s {n['steps_per_sec']}"
             f" (epochs {n['train_epochs']}, {n['epoch_seconds']} s); model built in {n['built']} s"
             f" ({n['built_parts']});"
             f" losses {n['losses']}; buffer reloads {n['reloads']}"
             f" (subset, s, native); checkpoints saved {n['saved']} (bytes, s), restored {n['restored']} s;"
             f" peak card memory {n['peak']} bytes")

    fit, resume = runs["fit"], runs["resume"]
    require(len(fit["steps_per_sec"]) == 3 and set(fit["train_epochs"]) == {0},
            f"fit: 3 logged steps in epoch 0 ({fit})")
    require(len(resume["steps_per_sec"]) == 3 and set(resume["train_epochs"]) == {1},
            f"resume: 3 logged steps, starting at epoch 1 ({resume})")
    meta = json.loads(pathlib.Path(last + ".meta.json").read_text())
    require(meta["step"] == 6 and meta["next_epoch"] == 2, f"resume ends at step 6, next epoch 2 ({meta})")
    require(len(resume["restored"]) == 1 and len(runs["validate"]["restored"]) == 1,
            "resume and validate restore the checkpoint")
    require(len(fit["saved"]) == 2 and len(resume["saved"]) == 2, "each fit saves last and best")
    require(all(r[2] for n in runs.values() for r in n["reloads"]), "the native loader ran")
    mix, _ = read_audio(str(tmp / "pred.wav"))
    require(mix.shape[0] == 2 and mix.shape[1] > SR and np.isfinite(mix).all() and np.abs(mix).max() > 0,
            f"predict wrote a finite stereo mix that is not all zeros ({mix.shape})")

    # the fit's three steps in this process, the counts read around them;
    # from the repository root, as the subprocesses run (the configs'
    # relative paths, logs/metrics.csv)
    import main_torch

    torch.cuda.empty_cache()
    inproc = overlay("in_process.yaml", {"num_sanity_val_steps": 0, "check_val_every_n_epoch": 1000,
                                         "enable_checkpointing": False})
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.chdir(root):
        main_torch.main(cmd("fit", inproc)[1:])
    counts = read_counts()
    here = _cli_numbers(out.getvalue())
    require(all(np.isfinite(x) for x in here["losses"]) and len(here["steps_per_sec"]) == 3,
            f"in process: three steps, losses finite ({here})")
    require(counts["K2"] == 12 and counts["K2-bwd"] == 6 and counts["K1"] == counts["K1-bwd"] == 0,
            f"three CLI steps: 4 K2 forward and 2 K2 backward launches each, no K1 ({counts})")

    def rate(n):
        return n["steps_per_sec"][1:]  # step 1 carries the first reload and cuDNN's first calls

    line(f"[cli] steps/s (steps 2-3 of each fit, TF32 off): fit {rate(fit)}, resume {rate(resume)},"
         f" in this process {rate(here)}; the [training] phase {training_steps_per_s:.3f};"
         f" train buffer reload"
         f" {[r[1] for n in (fit, resume) for r in n['reloads'] if r[0] == 'train']} s; checkpoint"
         f" {fit['saved'][0][0]} bytes, saves {[s for n in (fit, resume) for _, s in n['saved']]} s,"
         f" restores {resume['restored'] + runs['validate']['restored'] + runs['predict']['restored']} s;"
         f" peak card memory {max(p for n in runs.values() for p in n['peak']) / 2**30:.2f} GiB;"
         f" native loader ran: True; launches a CLI step {({k: v / 3 for k, v in counts.items()})}")
    return counts


# ------------------------------------------------------------ feature loss

FEATURE_WEIGHTS = [0.1, 0.001, 1.0, 1.0, 0.1]  # configs/models/naive+feat.yaml
FEATURE_TERMS = ("mix-rms", "mix-crest_factor", "mix-stereo_width", "mix-stereo_imbalance", "mix-barkspectrum")
# KE tracks: names of data/instrument_name2id.json, a stereo pair at 3-4
KE_INSTRUMENTS = ("bass drum", "snare drum", "drum set", "acoustic guitar", "acoustic guitar", "electric bass",
                  "piano", "vocalists")
FIT_MIXES = 4  # synthetic stereo reference mixes of 12 s for the Method-2 fit


def synth_ref_mixes(seed: int, n: int, length: int) -> np.ndarray:
    """(n, 2, length) stereo reference mixes: an enveloped mid channel and a
    quieter side channel of noise and tones, near -16 LUFS."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    out = np.empty((n, 2, length), np.float32)
    for i in range(n):
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        mid = env * (rng.standard_normal(length) + np.sin(2 * np.pi * rng.uniform(80.0, 800.0) * t))
        side = 0.3 * rng.standard_normal(length)
        out[i] = 0.08 * np.stack([mid + side, mid - side])
    return out


def _feature_steps(system, batch, flags, n, what, expect):
    """n timed train steps; each must give a finite loss and finite named
    terms and launch exactly ``expect`` (K2, K2-bwd) and no K1. Returns the
    walls, the summed launches and the last step's metrics."""
    walls, total = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(n):
        reset_counts()
        t0 = time.perf_counter()
        m = system.train_step(batch, flags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        terms = {k: float(v) for k, v in m.items() if k.startswith("mix-")}
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        line(f"[feature-loss] {what} step {step + 1}: {walls[-1]:.3f} s, loss {loss:.5g}, grad_norm {gn:.5g},"
             f" terms {terms}, K2 {counts['K2']}, K2-bwd {counts['K2-bwd']}")
        require(np.isfinite(loss) and np.isfinite(gn) and all(np.isfinite(v) for v in terms.values()),
                f"{what} step {step + 1}: loss, grad_norm and terms finite")
        require(int(m["pred_mix_nonfinite"]) == 0 and int(m["ref_mix_nonfinite"]) == 0,
                f"{what} step {step + 1}: mixes finite")
        require((counts["K2"], counts["K2-bwd"]) == expect and counts["K1"] == counts["K1-bwd"] == 0,
                f"{what} step {step + 1}: {expect[0]} K2 and {expect[1]} K2-bwd launches, no K1 ({counts})")
    peak = torch.cuda.max_memory_allocated()
    rate = (len(walls) - 1) / sum(walls[1:])
    line(f"[feature-loss] {what}: step{f's 2-{n}' if n > 2 else ' 2'} {rate:.3f} steps/s, step 1 {walls[0]:.3f} s;"
         f" peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    return walls, total, m


def _check_feature_loss_on_cpu(loss, pred, target):
    """The card's AudioFeatureLoss terms and their gradient by ``pred`` (one
    batch) against the same function on the CPU in float64: each term within
    1e-4 of the loss, the gradient within 1e-3 of its max-abs."""
    got, ref = {}, {}
    for dev, dtype, out in (("cuda", torch.float32, got), ("cpu", torch.float64, ref)):
        p = pred.detach().to(dev, dtype).requires_grad_()
        terms = loss(p, target.detach().to(dev, dtype))
        sum(terms.values()).backward()
        out.update(terms={k: float(v.detach()) for k, v in terms.items()}, grad=p.grad.double().cpu())
    total = sum(ref["terms"].values())
    term_err = max(abs(got["terms"][k] - v) for k, v in ref["terms"].items()) / abs(total)
    grad_err = float((got["grad"] - ref["grad"]).abs().max() / ref["grad"].abs().max())
    line(f"[feature-loss] AudioFeatureLoss on the card (float32) vs the CPU (float64), {tuple(pred.shape)}:"
         f" terms {term_err:.3g} of the loss {total:.6g}, gradient {grad_err:.3g} of its max-abs")
    require(list(got["terms"]) == list(FEATURE_TERMS), f"the loss's terms {list(got['terms'])}")
    require(term_err <= 1e-4, f"card and CPU feature-loss terms agree ({term_err})")
    require(grad_err <= 1e-3, f"card and CPU feature-loss gradients agree ({grad_err})")


def _fx_request(model, render_mode, seed):
    """One 60 s, 8-track request with the fx bus ("ola": the default
    console, K2; "streaming": the causal one, K3, K1, K5), its wall, and its
    distance from one render of the whole song with the same parameters and
    the request's first reverb row, past the first block, of the peak: a
    record, with no bound (the JAX package sets none)."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape
    from diffmst_torch.utils import inference

    console = AdvancedMixConsole(SR, **(CAUSAL if render_mode == "streaming" else {}))
    tracks, ref = synth_song(seed, N_TRACKS, SONG_S, quiet_track=N_TRACKS - 1)
    noise = draw_reverb_noise(torch.Generator().manual_seed(0),
                              reverb_noise_shape(inference._RENDER_BS, 2, console.reverb_num_samples,
                                                 console.reverb_num_taps), torch.device("cuda"))
    seen = {}

    def apply(t, r):
        seen["params"] = model(t, r)
        return seen["params"]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mix, td, _, _ = inference.run_diffmst(tracks, ref, apply, console, use_fx_bus=True,
                                          render_mode=render_mode, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    one = whole_song_render(console, tracks, seen["params"], use_fx_bus=True, noise=noise[:1])
    dry, *_ = inference.run_diffmst(tracks, ref, model, console, render_mode=render_mode)
    block = WINDOW // 2
    seam = float(np.abs(mix - one)[..., block:].max()) / float(np.abs(one).max())
    wet = float(np.abs(mix - dry).max()) / float(np.abs(dry).max())
    line(f"[feature-loss] fx-bus request ({render_mode}): {wall:.3f} s, {SONG_S / wall:.1f}x realtime;"
         f" against one render of the whole song (reverb row 0), past the first block:"
         f" {seam:.3g} of the peak (no bound); the fx bus moved the mix by {wet:.3g} of the dry peak;"
         f" launches {counts}")
    require(mix.shape == (1, 2, int(SONG_S * SR)) and np.isfinite(mix).all(), f"{render_mode} fx mix finite")
    require(wet > 1e-3, f"the fx bus is heard in the {render_mode} request ({wet})")
    require(td["compressor"]["ratio"].shape == (1, N_TRACKS - 1), "the quiet track was gated")
    return counts


def phase_feature_loss(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """The audio-feature loss, Method 2, KE mixes and the fx bus at full width
    (``naive.yaml``'s model, 4 x 8 x 262,144, TF32 off): (a) three Method-1
    steps with ``AudioFeatureLoss``, whose terms and gradient on one batch
    are held against the CPU; (b) three Method-2 steps on stereo reference
    mixes; (c) two KE steps with the fx bus on (reverb 65,536 samples, 1,023
    taps), KE's host milliseconds; (d) ``main_torch.py fit`` of 3 steps on
    ``naive.yaml`` + ``unpaired+feat.yaml`` over [cli]'s corpus under ``tmp``
    and synthetic mixes, a subprocess; (e) one 60 s, 8-track request with the
    fx bus, "ola", and one "streaming" with the causal console. Returns the
    phase's kernel launches."""
    import json as _json

    import yaml

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.data import write_audio
    from diffmst_torch.losses import AudioFeatureLoss, MultiResolutionSTFTLoss
    from diffmst_torch.mixing import knowledge_engineering_mix
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    console = AdvancedMixConsole(SR, **CONSOLE_RANGES)  # auto = K2; the reverb at 65,536 and 1,023
    loss = AudioFeatureLoss(sample_rate=44100, weights=FEATURE_WEIGHTS)
    batch = synth_batch(11)
    batch = batch._replace(tracks=batch.tracks.cuda(), track_padding=batch.track_padding.cuda())
    line(f"[feature-loss] model {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, batch"
         f" {TRAIN_BS} x {TRAIN_TRACKS} x {WINDOW}; loss {loss}")

    # (a) Method 1 with the feature loss
    system = System(model, console, loss, SystemConfig(), generator=torch.Generator().manual_seed(1))
    flags = system.effect_flags(0)
    _, counts, _ = _feature_steps(system, batch, flags, TRAIN_STEPS, "Method 1 + AudioFeatureLoss", (4, 2))
    add(counts)
    _, out = system.eval_step(batch, flags)
    _check_feature_loss_on_cpu(loss, out["pred_mix_b"], out["ref_mix_b"])
    del out

    # (b) Method 2: the batch's real (here synthetic) stereo reference mixes
    system = System(model, console, loss, SystemConfig(generate_mix=False),
                    generator=torch.Generator().manual_seed(2))
    m2_batch = batch._replace(ref_mix=torch.from_numpy(synth_ref_mixes(12, TRAIN_BS, WINDOW)).cuda())
    _, counts, _ = _feature_steps(system, m2_batch, system.effect_flags(0), TRAIN_STEPS, "Method 2", (2, 2))
    add(counts)
    del m2_batch

    # (c) KE mixes with the fx bus; the instrument ids stay on the host
    name2id = _json.loads((root / "data" / "instrument_name2id.json").read_text())
    ids = torch.tensor([[name2id[n] for n in KE_INSTRUMENTS]] * TRAIN_BS, dtype=torch.int32)
    stereo = torch.zeros(TRAIN_BS, TRAIN_TRACKS, dtype=torch.int32)
    stereo[:, 3] = 1
    system = System(model, console, MultiResolutionSTFTLoss(**MRSTFT), SystemConfig(active_fx_bus_epoch=0),
                    mix_fn=knowledge_engineering_mix, generator=torch.Generator().manual_seed(3))
    flags = system.effect_flags(0)
    require(flags.use_fx_bus, "KE steps with the fx bus")
    ke_ms = []
    sample = system._host_sample_ke

    def timed_sample(b):
        t0 = time.perf_counter()
        out = sample(b)
        ke_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    system._host_sample_ke = timed_sample
    _, counts, _ = _feature_steps(system, batch._replace(instrument_id=ids, stereo_info=stereo), flags, 2,
                                  "KE + fx bus", (4, 2))
    add(counts)
    line(f"[feature-loss] KE: host sampling {', '.join(f'{t:.2f}' for t in ke_ms)} ms a step"
         f" ({TRAIN_BS} x {TRAIN_TRACKS} tracks, data/knowledge_engineering.yaml)")
    require(len(ke_ms) == 2, "KE sampled on the host once a step")

    # (e) the fx bus in serving
    model.eval()
    add(_fx_request(model, "ola", 4))
    add(_fx_request(model, "streaming", 4))
    del system, model, batch
    torch.cuda.empty_cache()

    # (d) main_torch.py fit, Method 2 with the feature loss, as a user runs it
    mixes = tmp / "mixes"
    for i, mix in enumerate(synth_ref_mixes(13, FIT_MIXES, int(CLI_SONGS[2] * SR))):
        write_audio(str(mixes / f"mix{i}.wav"), mix, int(SR))
    overlay = tmp / "method2.yaml"
    overlay.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "num_sanity_val_steps": 0,
                    "check_val_every_n_epoch": 1000, "enable_checkpointing": False,
                    "default_root_dir": str(tmp / "ckpts_method2")},
        "data": {"init_args": {"track_root_dirs": [str(tmp / "corpus")],
                               "metadata_files": [str(tmp / "corpus" / "meta.yaml")],
                               "mix_root_dirs": [str(mixes)],
                               "num_examples_per_pass": 12, "num_train_passes": 1}},
    }))
    configs = [*(str(root / c) for c in CLI_CONFIGS), str(root / "configs/models/unpaired+feat.yaml"), str(overlay)]
    out, wall = _run_cli(root, ["main_torch.py", "fit", *(a for c in configs for a in ("-c", c))],
                         "main_torch.py fit (naive.yaml + unpaired+feat.yaml)")
    n = _cli_numbers(out)
    train_lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    line(f"[feature-loss] main_torch.py fit on naive.yaml + unpaired+feat.yaml: exit 0 in {wall:.1f} s;"
         f" [train] steps/s {n['steps_per_sec']}; losses {n['losses']}; model built in {n['built']} s;"
         f" buffer reloads {n['reloads']}; peak card memory {n['peak']} bytes")
    require(len(n["steps_per_sec"]) == 3, f"fit: 3 logged steps ({n['steps_per_sec']})")
    require(all(np.isfinite(x) for x in n["losses"]), f"fit: every logged loss finite ({n['losses']})")
    require(all(all(f"{t}=" in ln for t in FEATURE_TERMS) for ln in train_lines),
            "fit: the feature loss's terms logged each step")
    require(n["tf32"] == [("False", "False")], f"fit: TF32 off ({n['tf32']})")
    return launches


PE_MIXES, PE_SECONDS = 4, 12.0  # the synthetic 12 s stereo mixes of [param-est], and one silent file
PE_CLIP = 44100  # the HDemucs clip held against the CPU


def _timed(fn, reps=3):
    """fn's result and its mean wall over ``reps`` calls after a first one, ms."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0) / reps


def _rel_err(got, ref) -> float:
    return float((got.double().cpu() - ref.double().cpu()).abs().max() / ref.double().abs().max())


def phase_param_est(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """Parameter-estimation pretraining at full width, TF32 off: (a) a
    ``MixDataModule`` batch of 4 x 2 x 262,144 from synthetic 12 s mixes and
    a silent file under ``tmp``; (b) HPSS on the card, one song held against
    the CPU's float64 run; (c) the Remixer (HPSS, ``AdvancedMixConsole(44100)``,
    the fx bus on): 2 K2 launches and no K2-bwd a remix, against the kernels'
    plain versions on the same draws; (d) three ``ParameterEstimationSystem``
    steps with naive.yaml's encoder and a ``ParameterProjector``, and
    ``eval_step`` twice on a frozen remix; (e) HDemucs at HDEMUCS_HIGH from
    ``synthetic_hdemucs_state_dict(seed=0)``, strictly loaded: a batch's
    forward, a 1 s clip against the CPU's float64 run, and a step with the
    Remixer on it; (f) ``scripts/param_est_demo_torch.py 20 4``, a
    subprocess. Returns the phase's kernel launches."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.data import MixDataModule, write_audio
    from diffmst_torch.models import HDemucs, ParameterProjector, SpectrogramEncoder, synthetic_hdemucs_state_dict
    from diffmst_torch.models.separator import hpss_separator
    from diffmst_torch.ops.loudness import integrated_loudness
    from diffmst_torch.ops.reverb import draw_reverb_noise, reverb_noise_shape
    from diffmst_torch.train import ParameterEstimationSystem, Remixer
    from diffmst_torch.utils.checkpoint import port_hdemucs_state_dict

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the data
    mixes = tmp / "param_est_mixes"
    for i, mix in enumerate(synth_ref_mixes(21, PE_MIXES, int(PE_SECONDS * SR))):
        write_audio(str(mixes / f"mix{i}.wav"), mix, int(SR))
    write_audio(str(mixes / "silent.wav"), np.zeros((2, int(PE_SECONDS * SR)), np.float32), int(SR))
    t0 = time.perf_counter()
    batch = next(MixDataModule(root_dirs=[str(mixes)], length=WINDOW, batch_size=TRAIN_BS, seed=0).train_dataloader())
    data_s = time.perf_counter() - t0
    lufs = [integrated_loudness(b.T, SR) for b in batch]
    line(f"[param-est] data: MixDataModule batch {batch.shape} {batch.dtype} in {data_s:.3f} s from"
         f" {PE_MIXES} mixes of {PE_SECONDS:.0f} s and a silent one; loudness {', '.join(f'{v:.3f}' for v in lufs)}"
         f" LUFS, so the silent file was never drawn")
    require(batch.shape == (TRAIN_BS, 2, WINDOW) and np.isfinite(batch).all(), "the mix batch's shape")
    require(all(abs(v + 16.0) < 0.05 for v in lufs), f"every drawn mix at -16 LUFS, none silent ({lufs})")
    x = torch.from_numpy(batch).cuda()

    # (b) HPSS on the card
    stems, hpss_ms = _timed(lambda: hpss_separator(x))
    ref = hpss_separator(x[:1].double().cpu())
    err, rec = _rel_err(stems[:1], ref), _rel_err(stems.sum(dim=1), x)
    line(f"[param-est] hpss_separator {tuple(x.shape)} -> {tuple(stems.shape)}: {hpss_ms:.2f} ms a batch;"
         f" song 0 vs the CPU's float64 {err:.3g} of the peak; the stems sum to the mix within {rec:.3g}")
    require(err <= 1e-4, f"HPSS on the card agrees with the CPU ({err})")
    require(rec <= 1e-5, f"the HPSS stems sum to the mix ({rec})")
    del stems

    # (c) the Remixer: the same draws through K2 and through its plain version
    console = AdvancedMixConsole(SR)  # "auto" = K2; the fx bus's reverb at 65,536 samples and 1,023 taps
    remixer = Remixer(SR, separator=hpss_separator)
    gen = torch.Generator().manual_seed(5)
    tp = torch.rand(TRAIN_BS, 8, console.num_track_control_params, generator=gen).cuda()
    fp = torch.rand(TRAIN_BS, console.num_fx_bus_control_params, generator=gen).cuda()
    mp = torch.rand(TRAIN_BS, console.num_master_bus_control_params, generator=gen).cuda()
    noise = draw_reverb_noise(gen, reverb_noise_shape(TRAIN_BS, 2, console.reverb_num_samples,
                                                      console.reverb_num_taps), torch.device("cuda"))
    reset_counts()
    remixer(x, console, tp=tp, fp=fp, mp=mp, noise=noise)  # the first call makes cuFFT's plans
    add(read_counts())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    remix, *_ = remixer(x, console, tp=tp, fp=fp, mp=mp, noise=noise)
    torch.cuda.synchronize()
    remix_ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    add(counts)
    with plain_versions():
        plain, *_ = remixer(x, console, tp=tp, fp=fp, mp=mp, noise=noise)
    err, peak = _rel_err(remix, plain), float(remix.abs().max())
    line(f"[param-est] Remixer (hpss, AdvancedMixConsole(44100), fx bus on): {remix_ms:.1f} ms a warm remix;"
         f" against the kernels' plain versions {err:.3g} of the peak {peak:.4g}; K2 {counts['K2']},"
         f" K2-bwd {counts['K2-bwd']}")
    require(bool(torch.isfinite(remix).all()) and peak <= 4.0, f"the remix finite and within the clip ({peak})")
    require(err <= 1e-4, f"the remix through K2 agrees with the plain versions ({err})")
    require(counts["K2"] == 2 and counts["K2-bwd"] == 0 and counts["K1"] == 0,
            f"a remix launches 2 K2 and no K2-bwd ({counts})")
    del plain

    # (d) the system at full width
    encoder = SpectrogramEncoder(embed_dim=512, n_fft=2048, hop_length=512, cnn_base_width=64,
                                 input_batchnorm=False)  # configs/models/naive.yaml:30
    torch.manual_seed(0)
    projector = ParameterProjector(2 * 512, 8, console.num_track_control_params,
                                   console.num_fx_bus_control_params, console.num_master_bus_control_params)
    system = ParameterEstimationSystem(encoder, projector, console, remixer=remixer,
                                       generator=torch.Generator().manual_seed(6))
    n_params = sum(p.numel() for p in system.params)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(TRAIN_STEPS):
        reset_counts()
        t0 = time.perf_counter()
        m = system.train_step(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        add(counts)
        vals = {k: float(v) for k, v in m.items()}
        line(f"[param-est] step {step + 1}: {walls[-1]:.3f} s, losses {vals}, K2 {counts['K2']},"
             f" K2-bwd {counts['K2-bwd']}")
        require(all(np.isfinite(v) for v in vals.values()), f"step {step + 1}: the losses finite")
        require(counts["K2"] == 2 and counts["K2-bwd"] == 0, f"step {step + 1}: 2 K2, no K2-bwd ({counts})")
    step_peak = torch.cuda.max_memory_allocated()
    rate = (len(walls) - 1) / sum(walls[1:])
    line(f"[param-est] ParameterEstimationSystem, {n_params / 1e6:.1f} M params, batch {tuple(x.shape)}:"
         f" steps 2-{TRAIN_STEPS} {rate:.3f} steps/s, step 1 {walls[0]:.3f} s; peak memory"
         f" {step_peak / 2**30:.2f} GiB (max_memory_allocated)")
    frozen = remixer(x, console, torch.Generator().manual_seed(7))
    e1, e2 = system.eval_step(x, *frozen), system.eval_step(x, *frozen)
    line(f"[param-est] eval_step on a frozen remix, twice: {({k: float(v) for k, v in e1.items()})}")
    require(all(torch.equal(e1[k], e2[k]) for k in e1), "eval_step is deterministic")
    require(all(np.isfinite(float(v)) for v in e1.values()), "eval_step's losses finite")
    del frozen

    # (e) HDemucs at HDEMUCS_HIGH, from the synthetic torchaudio-layout state dict
    t0 = time.perf_counter()
    sd = synthetic_hdemucs_state_dict(seed=0)
    hdemucs = HDemucs()
    port_hdemucs_state_dict(sd, hdemucs)  # strict
    hdemucs_cpu = HDemucs().double().eval()
    hdemucs_cpu.load_state_dict(hdemucs.state_dict())
    hdemucs = hdemucs.eval().cuda()
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        stems, hd_ms = _timed(lambda: hdemucs(x), reps=2)
        hd_peak = torch.cuda.max_memory_allocated()
        clip = x[:1, :, :PE_CLIP]
        err = _rel_err(hdemucs(clip), hdemucs_cpu(clip.double().cpu()))
    line(f"[param-est] HDemucs (HDEMUCS_HIGH, {sum(v.size for v in sd.values()) / 1e6:.1f} M params, strict load"
         f" of synthetic_hdemucs_state_dict(seed=0) in {load_s:.2f} s): {tuple(x.shape)} -> {tuple(stems.shape)}"
         f" in {hd_ms:.1f} ms, peak {hd_peak / 2**30:.2f} GiB; a 1 x 2 x {PE_CLIP} clip vs the CPU's float64"
         f" {err:.3g} of the stems' max-abs")
    require(stems.shape == (TRAIN_BS, 4, 2, WINDOW) and bool(torch.isfinite(stems).all()), "HDemucs stems finite")
    require(err <= 1e-4, f"HDemucs on the card agrees with the CPU ({err})")
    del stems, hdemucs_cpu
    system.remixer = Remixer(SR, separator=hdemucs)
    reset_counts()
    t0 = time.perf_counter()
    m = system.train_step(x)
    torch.cuda.synchronize()
    counts = read_counts()
    add(counts)
    line(f"[param-est] a step with Remixer(separator=HDemucs): {time.perf_counter() - t0:.3f} s,"
         f" loss {float(m['loss']):.5g}, K2 {counts['K2']}, K2-bwd {counts['K2-bwd']}")
    require(np.isfinite(float(m["loss"])), "the HDemucs step's loss finite")
    require(counts["K2"] == 2 and counts["K2-bwd"] == 0, f"the HDemucs step: 2 K2, no K2-bwd ({counts})")
    del system, hdemucs, x
    torch.cuda.empty_cache()

    # (f) the demo, as a user runs it
    demo = tmp / "param_est_demo"
    demo.mkdir()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(root / "scripts" / "param_est_demo_torch.py"), "20", "4"],
                          cwd=demo, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"param_est_demo_torch.py exited {proc.returncode}:\n{proc.stdout[-2000:]}"
            f"\n{proc.stderr[-2000:]}")
    summary = json.loads((demo / "logs" / "param_est_demo_torch.json").read_text())
    line(f"[param-est] scripts/param_est_demo_torch.py 20 4: exit 0 in {wall:.1f} s, steps' wall"
         f" {summary['wall_s']} s, held-out loss {summary['heldout_eval_first']} -> {summary['heldout_eval_last']}"
         f" (constant-0.5 baseline {summary['constant_half_baseline']})")
    require(summary["backend"] == "cuda" and summary["steps"] == 20, "the demo ran 20 steps on the card")
    return launches


# ------------------------------------------------------------------- eval

EVAL_SONGS, EVAL_SECTION, EVAL_SECTIONS = 2, 441000, 2
ONLINE_ITERS, ONLINE_CHECK_ITERS = 20, 3
EXPORT_RENDER_BS = 8

# The serving process of [eval] (e): it imports only the kernels and the
# export module, loads the export, serves one song in "ola" and traces a
# second request. argv: repository root, export directory, song directory.
EXPORT_SERVER = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import diffmst_torch.kernels
from diffmst_torch.kernels import comp_fused, scan1p
from diffmst_torch.utils.export import kernel_nodes, load_inference_export, run_exported
from diffmst_torch.utils.device import use_full_float32

use_full_float32()
assert "diffmst_torch.models" not in sys.modules and "diffmst_torch.console" not in sys.modules
plain = {"K2": 0, "K1": 0}
forward_plain, onepole_plain = comp_fused._forward_plain, scan1p.onepole_core_plain
def counted(key, fn):
    def call(*a, **k):
        plain[key] += 1
        return fn(*a, **k)
    return call
comp_fused._forward_plain = counted("K2", forward_plain)
scan1p.onepole_core_plain = counted("K1", onepole_plain)
song = sys.argv[3]
tracks, ref = np.load(song + "/tracks.npy"), np.load(song + "/ref.npy")
t0 = time.perf_counter()
ex = load_inference_export(sys.argv[2])
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
comp_fused.compressor_fused_gain.launches = 0
t0 = time.perf_counter()
mix = run_exported(ex, tracks, ref, render_mode="ola")
torch.cuda.synchronize()
cold_s = time.perf_counter() - t0
launches = comp_fused.compressor_fused_gain.launches
t0 = time.perf_counter()
run_exported(ex, tracks, ref, render_mode="ola")
torch.cuda.synchronize()
warm_s = time.perf_counter() - t0
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run_exported(ex, tracks, ref, render_mode="ola")
    torch.cuda.synchronize()
cuda = torch.autograd.DeviceType.CUDA
names = [e.name for e in prof.events() if e.device_type == cuda]
ops = [e.name for e in prof.events() if e.device_type != cuda and e.name.startswith("diffmst::")]
np.save(song + "/exported_mix.npy", mix)
print(json.dumps(dict(
    load_s=load_s, cold_s=cold_s, warm_s=warm_s, k2_launches=launches,
    traced_k2_kernels=sum("CompressorOp" in n for n in names), traced_device_events=len(names),
    traced_ops={n: ops.count(n) for n in sorted(set(ops))}, plain_calls=plain,
    render_nodes=kernel_nodes(ex.programs[1]), predict_nodes=kernel_nodes(ex.programs[0]),
    device=ex.manifest["device"], modules_loaded=sorted(m for m in sys.modules if m.startswith("diffmst_torch.")),
)))
"""


def _eval_in_process(d: pathlib.Path, ev, ckpt: pathlib.Path, ckpt_s: float) -> dict:
    """[eval] (a)-(c) and (f), in this process: the songs,
    ``eval_all_combo_torch.py``'s ``main``, the online loop, the listening
    sweep and ``run_torch.py``. Returns their kernel launches."""
    import csv
    import importlib

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.data import write_audio
    from diffmst_torch.ops.loudness import integrated_loudness
    from diffmst_torch.utils import inference

    songs = d / "songs"
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    importlib.import_module("scripts.make_eval_songs_torch").main(
        ["--out", str(songs), "--n", str(EVAL_SONGS), "--t", str(int(SONG_S * SR))])
    for song in songs.iterdir():  # the last stem silent: the gate drops it
        write_audio(str(song / "tracks" / f"stem_{N_TRACKS - 1:02d}.wav"),
                    np.zeros((2, int(SONG_S * SR)), np.float32), int(SR))
    line(f"[eval] (a) {EVAL_SONGS} songs of {SONG_S:.0f} s, {N_TRACKS} stems (one silent) in"
         f" {time.perf_counter() - t0:.2f} s; checkpoint {ckpt.stat().st_size} bytes saved in {ckpt_s:.2f} s")

    # (b) eval_all_combo_torch.py's main, each request timed and counted
    walls, k2s = [], []
    run = ev.run_diffmst

    def timed_run(*args, **kwargs):
        torch.cuda.synchronize()
        k2 = read_counts()["K2"]
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        k2s.append(read_counts()["K2"] - k2)
        return out

    reset_counts()
    uploads = inference.track_uploads
    ev.run_diffmst = timed_run
    t0 = time.perf_counter()
    try:
        rows = ev.main(["--examples_dir", str(songs), "--output_dir", str(d / "eval_out"), "--ckpt", str(ckpt),
                        "--section_len", str(EVAL_SECTION), "--num_sections", str(EVAL_SECTIONS)])
    finally:
        ev.run_diffmst = run
    main_s = time.perf_counter() - t0
    uploads = inference.track_uploads - uploads
    counts = read_counts()
    add(counts)
    with open(d / "eval_out" / "results.csv") as f:
        csv_rows = list(csv.DictReader(f))
    numbers = [float(v) for r in csv_rows for k, v in r.items() if k not in ("song", "method")]
    line(f"[eval] (b) eval_all_combo_torch.py: {len(csv_rows)} rows in {main_s:.2f} s; {len(walls)} requests,"
         f" request 1 {walls[0]:.3f} s, the warm ones {min(walls[1:]):.3f}-{max(walls[1:]):.3f} s"
         f" (mean {np.mean(walls[1:]):.3f}); uploads {uploads} ({EVAL_SONGS} songs); K2 a request {sorted(set(k2s))};"
         f" launches {counts}")
    require(len(csv_rows) == 2 * EVAL_SONGS * EVAL_SECTIONS**2 == len(rows), f"16 CSV rows ({len(csv_rows)})")
    require(list(csv_rows[0]) == ["song", "method", "track_start", "ref_start"]
            + [f"{w}_{k}" for w in ("mix", "ref") for k in ("rms", "crest_factor", "stereo_width",
                                                            "stereo_imbalance", "barkspectrum_mean")]
            + ["mrstft_to_ref", "sisdr_to_ref"], f"the JAX script's columns ({list(csv_rows[0])})")
    require(all(np.isfinite(numbers)), "every CSV number finite")
    require(uploads == EVAL_SONGS, f"one upload a song ({uploads})")
    require(k2s == [12] * len(walls), f"12 K2 launches a request ({k2s})")
    require(counts["K2-bwd"] == 0 and counts["K1"] == 0, "the eval went through K2 alone")

    # (c) the online loop: Adam through the differentiated console
    online = importlib.import_module("scripts.online_torch")
    console = AdvancedMixConsole(SR)
    tracks, ref = ev.load_song(str(songs / "song_00"))
    block = tracks[..., :WINDOW].copy()
    for i in range(block.shape[1]):
        lufs = integrated_loudness(block[0, i], SR)
        if np.isfinite(lufs):
            block[0, i] *= 10 ** ((-48.0 - lufs) / 20.0)
    block_t = torch.from_numpy(block).cuda()
    ref_t = torch.from_numpy(np.ascontiguousarray(ref[..., :WINDOW])).cuda()
    init = online.init_raw_params(1, N_TRACKS, console, torch.Generator().manual_seed(0))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        *_, history = online.optimize_params(block_t, ref_t, console, n_iters=ONLINE_ITERS, log_every=1,
                                             init_raw=init)
    torch.cuda.synchronize()
    online_s = time.perf_counter() - t0
    counts = read_counts()
    add(counts)
    line(f"[eval] (c) optimize_params: {ONLINE_ITERS} iterations on 1 x {N_TRACKS} x {WINDOW} in {online_s:.2f} s"
         f" ({ONLINE_ITERS / online_s:.2f} it/s), loss {history[0]:.5f} -> {history[-1]:.5f};"
         f" an iteration: K2 {counts['K2'] / ONLINE_ITERS:g}, K2-bwd {counts['K2-bwd'] / ONLINE_ITERS:g}")
    require(all(np.isfinite(history)) and history[-1] < history[0], "the online loss falls")
    require(counts["K2"] == 2 * ONLINE_ITERS and counts["K2-bwd"] == 2 * ONLINE_ITERS,
            f"K2 and K2-bwd twice an iteration ({counts})")
    with contextlib.redirect_stdout(io.StringIO()):
        # launches made for this comparison are not counted
        got = online.optimize_params(block_t, ref_t, console, n_iters=ONLINE_CHECK_ITERS, init_raw=init)[:3]
        with plain_versions():
            want = online.optimize_params(block_t, ref_t, console, n_iters=ONLINE_CHECK_ITERS, init_raw=init)[:3]
    errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    line(f"[eval] (c) {ONLINE_CHECK_ITERS} iterations through the kernels vs the plain versions on the card:"
         f" parameters off by {', '.join(f'{e:.3g}' for e in errs)} of their max-abs (track, fx, master)")
    require(max(errs) <= 1e-4, f"the online parameters agree with the plain versions' ({errs})")

    # (f) the listening sweep and one song from the command line's entry
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        written = importlib.import_module("scripts.eval_listen_torch").main(
            ["--examples_dir", str(songs), "--output_dir", str(d / "listen"), "--ckpt", str(ckpt),
             "--levels", "-24", "-12"])
    listen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mix = importlib.import_module("scripts.run_torch").main(
            ["--track_dir", str(songs / "song_01" / "tracks"), "--ref", str(songs / "song_01" / "ref.wav"),
             "--output", str(d / "run.wav"), "--ckpt", str(ckpt)])
    run_s = time.perf_counter() - t0
    counts = read_counts()
    add(counts)
    line(f"[eval] (f) eval_listen_torch.py: {len(written)} wavs in {listen_s:.2f} s; run_torch.py: a"
         f" {mix.shape} mix in {run_s:.2f} s; launches {counts}")
    require(len(written) == 2 * EVAL_SONGS and all(pathlib.Path(w).exists() for w in written), "4 listening wavs")
    require(np.isfinite(mix).all() and (d / "run.wav").exists(), "run_torch.py wrote its mix")
    return launches


def phase_eval(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """Evaluation and serving as a user runs them, at full width
    (``configs/models/naive.yaml``'s model with seeded weights saved as a
    port checkpoint, ``AdvancedMixConsole(44100)``): (a) two 60 s, 8-track
    songs from ``scripts/make_eval_songs_torch.py`` (one stem silent, under
    the gate); (b) ``scripts/eval_all_combo_torch.py``'s ``main`` over them
    (2 sections of 441,000: 4 combinations a song, 16 CSV rows), one upload
    a song and 12 K2 launches a request, and one combination rendered again
    with the track cache cleared, bitwise equal; (c) ``scripts/
    online_torch.py::optimize_params``, 20 iterations on a 262,144-sample
    block (K2 and K2-bwd), 3 of them held against the same loop on the
    kernels' plain versions on the card; (d) ``main_torch.py export`` as a
    subprocess (8 tracks, window 262,144, 8 windows a render call), which
    runs beside (a)-(c) and (f), so the combination of (b) is rendered
    again, cached and uncached, alone on the card after it; (e) a second
    subprocess that imports only ``diffmst_torch.kernels`` and
    ``diffmst_torch.utils.export``, loads the export and serves a song by
    ``run_exported``, within 1e-4 of the peak of ``run_diffmst``'s mix, its
    render through K2 (6 launches a request, traced) and no plain version;
    (f) ``scripts/eval_listen_torch.py`` over the 2 songs at 2 levels and
    ``scripts/run_torch.py`` on one song. Returns the phase's kernel
    launches."""
    import importlib

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.utils import inference

    ev = importlib.import_module("scripts.eval_all_combo_torch")
    phase_t0 = time.perf_counter()
    d = tmp / "eval"
    songs = d / "songs"
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # the seeded weights as a port checkpoint; (d) main_torch.py export, as
    # a user runs it, in the background while (a)-(c) and (f) run here
    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    ckpt = d / "model.pt"
    d.mkdir(parents=True)
    t0 = time.perf_counter()
    torch.save({"model": model.state_dict()}, ckpt)
    ckpt_s = time.perf_counter() - t0
    export_dir = d / "serving_export"
    export_t0 = time.perf_counter()
    with open(d / "export.out", "w") as out_f, open(d / "export.err", "w") as err_f:
        exporter = subprocess.Popen(
            [sys.executable, "main_torch.py", "export", "-c", "configs/config.yaml", "-c",
             "configs/models/naive.yaml", "--ckpt_path", str(ckpt), "--num_tracks", str(N_TRACKS),
             "--analysis_len", str(WINDOW), "--render_bs", str(EXPORT_RENDER_BS), "--output", str(export_dir)],
            cwd=root, stdout=out_f, stderr=err_f, text=True)
        try:
            launches.update(_eval_in_process(d, ev, ckpt, ckpt_s))
        finally:
            try:
                exporter.wait(timeout=300)
            except subprocess.TimeoutExpired:
                exporter.kill()
                exporter.wait()
    export_wall = time.perf_counter() - export_t0
    out = (d / "export.out").read_text()
    if exporter.returncode != 0:
        raise RuntimeError(f"check failed: main_torch.py export exited {exporter.returncode}:\n"
                           f"{out[-3000:]}\n{(d / 'export.err').read_text()[-3000:]}")
    export_line = [ln for ln in out.splitlines() if ln.startswith("export: wrote")]
    export_bytes = sum(f.stat().st_size for f in export_dir.iterdir())
    line(f"[eval] (d) main_torch.py export (beside (a)-(c), (f)): exit 0 in {export_wall:.1f} s; {export_line[-1]};"
         f" {export_bytes} bytes")

    # (b) one combination again, alone on the card: cached, then uncached
    console = AdvancedMixConsole(SR)
    apply = ev.model_apply(model)
    tracks, ref = ev.load_song(str(d / "songs" / "song_00"))
    reset_counts()
    mixes = []
    for clear in (False, False, True):
        if clear:
            inference.clear_track_cache()
        before = inference.track_uploads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mix, td, _, _ = inference.run_diffmst(tracks, ref, apply, console)
        torch.cuda.synchronize()
        mixes.append((mix, time.perf_counter() - t0, inference.track_uploads - before))
    counts = read_counts()
    add(counts)
    line(f"[eval] (b) song_00 (0, 0) three times, the cache cleared before the third: walls"
         f" {', '.join(f'{w:.3f}' for _, w, _ in mixes)} s, uploads {[u for _, _, u in mixes]},"
         f" bitwise equal {all(np.array_equal(m, mixes[0][0]) for m, _, _ in mixes)}")
    require([u for _, _, u in mixes] == [1, 0, 1], "an upload, a hit, an upload after clearing")
    require(all(np.array_equal(m, mixes[0][0]) for m, _, _ in mixes), "cached and uncached mixes bitwise equal")
    require(td["compressor"]["ratio"].shape == (1, N_TRACKS - 1), "the silent stem was gated")
    reference_mix, warm_wall = mixes[0][0], mixes[1][1]

    # (e) a fresh process serves the export
    song_npy = d / "song_npy"
    song_npy.mkdir()
    np.save(song_npy / "tracks.npy", tracks)
    np.save(song_npy / "ref.npy", ref)
    server = d / "export_server.py"
    server.write_text(EXPORT_SERVER)
    out, serve_wall = _run_cli(root, [str(server), str(root), str(export_dir), str(song_npy)],
                               "the export's serving process")
    served = json.loads(out.strip().splitlines()[-1])
    exported_mix = np.load(song_npy / "exported_mix.npy")
    peak = float(np.abs(reference_mix).max())
    err = float(np.abs(exported_mix - reference_mix).max())
    add({"K2": served["k2_launches"]})
    line(f"[eval] (e) run_exported in a fresh process: exit 0 in {serve_wall:.1f} s; load {served['load_s']:.2f} s,"
         f" request 1 {served['cold_s']:.3f} s, request 2 {served['warm_s']:.3f} s (run_diffmst's warm"
         f" {warm_wall:.3f} s); K2 launches {served['k2_launches']}, traced K2 kernels"
         f" {served['traced_k2_kernels']} of {served['traced_device_events']} device events, ops"
         f" {served['traced_ops']}; graph nodes {served['render_nodes']}; plain calls {served['plain_calls']};"
         f" vs run_diffmst {err:.3g} of peak {peak:.3g}")
    require(served["device"] == "cuda" and not any(m.startswith(("diffmst_torch.models", "diffmst_torch.console"))
                                                   for m in served["modules_loaded"]),
            "the export served on the card without the model's or the console's code")
    require(served["render_nodes"] == {"diffmst::compressor_fused_gain": 2}, "the render graph holds K2's node twice")
    require(served["k2_launches"] == 6 and served["traced_k2_kernels"] == 6,
            f"6 K2 launches a request ({served['k2_launches']}, traced {served['traced_k2_kernels']})")
    require(served["plain_calls"] == {"K2": 0, "K1": 0}, "no plain version ran")
    require(exported_mix.shape == reference_mix.shape and np.isfinite(exported_mix).all(), "exported mix finite")
    require(err <= 1e-4 * peak, f"the exported mix agrees with run_diffmst's ({err} of {peak})")

    line(f"[eval] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


# ------------------------------------------------------- the TPU recipe

TPU_CONFIGS = ("configs/config.yaml", "configs/optimizer.yaml", "configs/models/naive+tpu.yaml")
RECIPE_BF16_TOL = 0.05  # tests/test_models.py::test_bf16_compute_close_to_f32


def _recipe_step(system, batch, flags, ref_params):
    """One timed train step; returns (wall s, peak bytes, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = system.train_step(batch, flags, ref_params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    require(np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), "recipe step finite")
    return wall, torch.cuda.max_memory_allocated(), counts


def _running_stats(model) -> dict:
    return {k: v.clone() for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))}


def phase_tpu_recipe(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """``configs/models/naive+tpu.yaml`` (bf16 compute, no remat, Cnn14 at
    its reference widths, Adam's first moment in bf16) at full width: (a)
    its System through ``main_torch.build_from_config`` and the dtypes; (b)
    the bf16 model against its float32 twin on the same weights; (c) the
    console's cotangents through K2 and K2-bwd against the plain versions,
    then 3 timed steps; (d) a step each with ``remat_encoders`` and
    ``remat_blocks=2``, the running statistics against a plain step's; (e)
    a ``flatten_optimizer`` update against the per-leaf one from the same
    state; (f) a 60 s, 8-track "ola" request with the bf16 model against
    the float32 one; (g) ``main_torch.py fit`` and a resume over [cli]'s
    corpus, subprocesses. Returns the phase's kernel launches."""
    import dataclasses

    import main_torch
    from diffmst_torch.mixing import naive_random_mix
    from diffmst_torch.mixing.naive import draw_mix_params
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System
    from diffmst_torch.train.system import OptaxAdam, _global_norm
    from diffmst_torch.utils.config import load_config
    from diffmst_torch.utils.inference import run_diffmst

    phase_t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the recipe's System, as main_torch.py fit builds it
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.chdir(root):
        system, _, _ = main_torch.build_from_config(load_config([str(root / c) for c in TPU_CONFIGS]))
    model, console = system.model, system.mix_console
    built = out.getvalue().strip().splitlines()[-1]
    enc = model.track_encoder
    n_params = sum(p.numel() for p in model.parameters())
    require(enc.model.dtype == torch.bfloat16 and model.controller.transformer_encoder.layers[0].dtype
            == torch.bfloat16, "naive+tpu.yaml computes in bf16")
    require(not enc.remat and enc.model.remat_blocks == 0 and enc.model.conv_block1.conv1.out_channels == 64,
            "naive+tpu.yaml: no remat, Cnn14's reference widths")
    require(isinstance(system.optimizer, OptaxAdam) and system.optimizer_layout == "per-leaf, mu bfloat16",
            f"naive+tpu.yaml's optimizer ({system.optimizer_layout})")
    state_dtypes = {v.dtype for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    require(state_dtypes == {torch.float32}, f"parameters and BatchNorm statistics float32 ({state_dtypes})")
    line(f"[tpu-recipe] (a) {built}; {n_params / 1e6:.1f} M parameters, compute bf16, optimizer"
         f" {system.optimizer_layout}; parameters and BatchNorm statistics {sorted(map(str, state_dtypes))}")

    batch = synth_batch(11)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = system.effect_flags(0)
    ref_params = draw_mix_params(batch.tracks, console, torch.Generator().manual_seed(2))

    # (b) bf16 against float32 on the same weights, eval mode
    twin = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    twin.load_state_dict(model.state_dict())
    with torch.no_grad():
        _, outputs = system.eval_step(batch, flags, ref_params)
        tracks_b = batch.tracks[..., HALF:]
        p16 = model(tracks_b, outputs["ref_mix_a"], batch.track_padding)
        p32 = twin(tracks_b, outputs["ref_mix_a"], batch.track_padding)
    dev = {name: float((a - b).abs().max()) for name, a, b in zip(("track", "fx", "master"), p16, p32)}
    require(all(a.dtype == torch.float32 for a in p16), "the bf16 model's outputs are float32")
    line(f"[tpu-recipe] (b) bf16 vs float32 on the same weights and batch, eval mode: predicted parameters"
         f" max-abs {', '.join(f'{k} {v:.3g}' for k, v in dev.items())} (gate {RECIPE_BF16_TOL})")
    require(max(dev.values()) <= RECIPE_BF16_TOL, f"bf16 within {RECIPE_BF16_TOL} of float32 ({dev})")

    # (c) the console's cotangents through the kernels and the plain
    # versions, at the same weights, statistics and reference mix (rendered
    # once, through K2: the bf16 model turns the two renders' 1e-9
    # difference into 1e-3 of the loss), cuDNN deterministic; then three
    # timed steps
    stats = {k: v.clone() for k, v in model.named_buffers()}
    ref_once = {}

    def fixed_reference(tracks, console_, generator, **kw):
        if "ref" not in ref_once:
            ref_once["ref"] = naive_random_mix(tracks, console_, generator, **kw)
        return ref_once["ref"]

    def grad_pass():
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(stats[k])
        for p in system.params:
            p.grad = None
        loss, _, out = system.forward(batch, flags, True, ref_params)
        cot = {}
        pred_track, _, pred_master = out["pred_params"]
        pred_track.register_hook(lambda g: cot.__setitem__("track", g.detach().clone()))
        pred_master.register_hook(lambda g: cot.__setitem__("master", g.detach().clone()))
        system.backward(loss)
        return float(loss.detach()), cot, [p.grad.clone() for p in system.params]

    torch.backends.cudnn.deterministic = True
    system.mix_fn = fixed_reference
    reset_counts()
    loss_k, cot_k, g_k = grad_pass()
    kernel_counts = read_counts()
    with plain_versions():
        reset_counts()
        loss_p, cot_p, g_p = grad_pass()
        plain_counts = read_counts()
    torch.backends.cudnn.deterministic = False
    system.mix_fn = naive_random_mix
    del ref_once

    def rel(a, b):
        return float(torch.sqrt(sum(((x.double() - y.double()) ** 2).sum() for x, y in zip(a, b)))
                     / torch.sqrt(sum((y.double() ** 2).sum() for y in b)))

    cot_rel = {k: rel([cot_k[k]], [cot_p[k]]) for k in ("track", "master")}
    grad_rel = rel(g_k, g_p)
    del g_k, g_p
    line(f"[tpu-recipe] (c) one step's gradients through K2 and K2-bwd vs the plain versions on the card:"
         f" loss {loss_k:.7f} vs {loss_p:.7f}; the console's cotangents at the predicted parameters, of"
         f" their norm: {', '.join(f'{k} {v:.3g}' for k, v in cot_rel.items())}; the model's gradients"
         f" {grad_rel:.3g} of their norm; launches {kernel_counts} (plain pass {plain_counts})")
    require(kernel_counts["K2"] == 4 and kernel_counts["K2-bwd"] == 2, f"the kernel pass: K2 4, K2-bwd 2 ({kernel_counts})")
    require(not any(plain_counts.values()), f"the plain pass launched no kernel ({plain_counts})")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "kernel and plain losses agree")
    require(max(cot_rel.values()) <= 2e-2, f"kernel and plain cotangents agree ({cot_rel})")

    walls, peaks = [], []
    for step in range(TRAIN_STEPS):
        wall, peak, counts = _recipe_step(system, batch, flags, None)
        walls.append(wall)
        peaks.append(peak)
        add(counts)
        require(counts["K2"] == 4 and counts["K2-bwd"] == 2 and counts["K1"] == counts["K1-bwd"] == 0,
                f"recipe step {step + 1}: 4 K2 and 2 K2-bwd launches ({counts})")
        line(f"[tpu-recipe] (c) step {step + 1}: {wall:.3f} s, peak {peak / 2**30:.2f} GiB, launches {counts}")
    opt = system.optimizer
    require({m.dtype for m in opt.mu} == {torch.bfloat16} and {v.dtype for v in opt.nu} == {torch.float32},
            "after the steps Adam's mu is bf16 and nu float32")
    per_step = sum(walls[1:]) / (len(walls) - 1)
    audio_s = TRAIN_BS * WINDOW / SR
    line(f"[tpu-recipe] (c) steps 2-{TRAIN_STEPS}: {1.0 / per_step:.3f} steps/s ({per_step:.3f} s a step,"
         f" {audio_s / per_step:.1f} s of audio a second); step 1 {walls[0]:.3f} s; peak memory"
         f" {max(peaks) / 2**30:.2f} GiB (max_memory_allocated); Adam mu bf16, nu float32")
    add(phase_train_profile(system, batch, flags, tag="tpu-recipe (c) profile"))

    # (d) remat: a step each from the same state, the running statistics
    # against a plain step's (cuDNN deterministic)
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    stats0 = _running_stats(model)
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, (whole, blocks) in (("plain", (False, 0)), ("remat_encoders", (True, 0)),
                                  ("remat_blocks=2", (False, 2))):
        model.load_state_dict(snap)
        for e in (model.track_encoder, model.mix_encoder):
            e.remat, e.model.remat_blocks = whole, blocks
        wall, peak, counts = _recipe_step(system, batch, flags, ref_params)
        add(counts)
        runs[name] = (wall, peak, _running_stats(model))
    for e in (model.track_encoder, model.mix_encoder):
        e.remat, e.model.remat_blocks = False, 0
    torch.backends.cudnn.deterministic = False
    plain_stats = runs["plain"][2]
    moved = max(float((plain_stats[k] - stats0[k]).abs().max()) for k in stats0)
    for name in ("remat_encoders", "remat_blocks=2"):
        wall, peak, st = runs[name]
        diff = max(float((st[k] - plain_stats[k]).abs().max()) for k in st)
        line(f"[tpu-recipe] (d) {name}: {wall:.3f} s, peak {peak / 2**30:.2f} GiB (plain step"
             f" {runs['plain'][0]:.3f} s, {runs['plain'][1] / 2**30:.2f} GiB, deterministic cuDNN);"
             f" running statistics vs the plain step's: max-abs {diff:.3g} (the step moved them by {moved:.3g})")
        require(moved > 0 and diff <= 1e-6 * max(moved, 1.0), f"{name}: the running statistics updated once ({diff})")

    # (e) flatten_optimizer: one update from the same state and gradients
    model.load_state_dict(snap)
    del snap
    system.gradients(batch, flags, ref_params)
    grads = [p.grad.clone() for p in system.params]
    flat = System(model, console, system.loss, dataclasses.replace(system.config, flatten_optimizer=True),
                  device=system.device)
    flat.updates = system.updates  # the same learning rate
    with torch.no_grad():
        flat.optimizer.mu[0].copy_(torch.cat([m.reshape(-1) for m in opt.mu]))
        flat.optimizer.nu[0].copy_(torch.cat([v.reshape(-1) for v in opt.nu]))
        flat.optimizer.count = opt.count
        before = [p.detach().clone() for p in system.params]
        timings = {}
        for name, s in (("per-leaf", system), ("flat", flat)):
            for p, b, g in zip(system.params, before, grads):
                p.copy_(b)
                p.grad = g.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.apply_gradients(_global_norm([p.grad for p in system.params]))
            torch.cuda.synchronize()
            timings[name] = (time.perf_counter() - t0, [p.detach().clone() for p in system.params])
    leaf_p, flat_p = timings["per-leaf"][1], timings["flat"][1]
    flat_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(flat_p, leaf_p))
    moved_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(leaf_p, before))
    line(f"[tpu-recipe] (e) flatten_optimizer from the same state and gradients: parameters within"
         f" {flat_rel:.3g} of the per-leaf update's (worst leaf, of its max-abs; the update moved them by up to"
         f" {moved_rel:.3g}); the optimizer {timings['flat'][0] * 1e3:.1f} ms flat,"
         f" {timings['per-leaf'][0] * 1e3:.1f} ms per leaf; flat mu {tuple(flat.optimizer.mu[0].shape)}"
         f" {flat.optimizer.mu[0].dtype}")
    require(moved_rel > 0 and flat_rel <= 1e-6, f"the flat update agrees with the per-leaf one ({flat_rel})")
    del flat, grads, before, timings, leaf_p, flat_p
    for p in system.params:
        p.grad = None
    torch.cuda.empty_cache()

    # (f) a 60 s, 8-track request with the bf16 model and the float32 twin
    twin.load_state_dict(model.state_dict())
    tracks, ref = synth_song(21, N_TRACKS, SONG_S, quiet_track=N_TRACKS - 1)
    mixes = {}
    for name, m in (("float32 cold", twin), ("bf16", model), ("float32", twin), ("bf16 again", model)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mix, _, _, _ = run_diffmst(tracks, ref, m, console)
        torch.cuda.synchronize()
        mixes[name] = (mix, time.perf_counter() - t0, read_counts())
    add(mixes["bf16"][2])
    peak = float(np.abs(mixes["float32"][0]).max())
    mix_dev = float(np.abs(mixes["bf16"][0] - mixes["float32"][0]).max()) / peak
    line(f"[tpu-recipe] (f) a {SONG_S:.0f} s, {N_TRACKS}-track request (\"ola\"), the song uploaded by the"
         f" first: float32 {', '.join(f'{SONG_S / mixes[k][1]:.1f}x' for k in ('float32 cold', 'float32'))},"
         f" bf16 {', '.join(f'{SONG_S / mixes[k][1]:.1f}x' for k in ('bf16', 'bf16 again'))} realtime; the bf16"
         f" mix {mix_dev:.3g} of the peak from the float32 one; launches {mixes['bf16'][2]}")
    require(np.isfinite(mixes["bf16"][0]).all() and mixes["bf16"][2]["K2"] > 0, "the bf16 request: finite, via K2")
    del model, twin, system, opt, enc, outputs, p16, p32
    torch.cuda.empty_cache()

    # (g) main_torch.py fit and a resume over [cli]'s corpus, subprocesses
    import yaml

    corpus, ckpts = tmp / "corpus", tmp / "tpu_ckpts"
    data = {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
            "num_examples_per_pass": 12, "num_train_passes": 1}
    argv = {}
    for name, epochs in (("fit", 1), ("resume", 2)):
        p = tmp / f"tpu_{name}.yaml"
        p.write_text(yaml.safe_dump({"trainer": {"max_epochs": epochs, "log_every_n_steps": 1,
                                                 "num_sanity_val_steps": 0, "default_root_dir": str(ckpts)},
                                     "data": {"init_args": data}}))
        configs = [*(str(root / c) for c in TPU_CONFIGS[:2]), str(root / "configs/data/synthetic-8.yaml"),
                   str(root / TPU_CONFIGS[2]), str(p)]
        argv[name] = ["main_torch.py", "fit", *(a for c in configs for a in ("-c", c))]
    argv["resume"] += ["--ckpt_path", str(ckpts / "last")]
    for name in ("fit", "resume"):
        out, wall = _run_cli(root, argv[name], f"main_torch.py fit on naive+tpu.yaml ({name})")
        n = _cli_numbers(out)
        state = torch.load(ckpts / "last", map_location="cpu", weights_only=True, mmap=True)
        layout, mu = state["optimizer_layout"], state["optimizer"]["mu"]
        line(f"[tpu-recipe] (g) main_torch.py fit ({name}): exit 0 in {wall:.1f} s; [train] steps/s"
             f" {n['steps_per_sec']} (epochs {n['train_epochs']}); losses {n['losses']}; checkpoints"
             f" {n['saved']} (bytes, s); peak card memory {n['peak']} bytes; the checkpoint's optimizer"
             f" {layout}, step {state['step']}")
        require(len(n["steps_per_sec"]) == 3 and all(np.isfinite(x) for x in n["losses"]),
                f"{name}: three logged steps, losses finite ({n})")
        require(layout == "per-leaf, mu bfloat16" and {m.dtype for m in mu} == {torch.bfloat16},
                f"{name}: the checkpoint's mu is bf16 ({layout})")
        require(state["step"] == (3 if name == "fit" else 6), f"{name}: the checkpoint's step ({state['step']})")
        del state, mu
    line(f"[tpu-recipe] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


OBSERVE_SCRIPTS = ("compare_torch.py", "datasets_torch.py", "info_torch.py", "unet_separator_demo_torch.py")


def phase_observe(root: pathlib.Path, tmp: pathlib.Path, k2_ms: float) -> dict:
    """Tracing and logging a fit, and the ballistics smoother on the
    training path. (a) ``Trainer.fit`` of 3 steps over [cli]'s corpus at
    ``naive.yaml``'s full width, built by ``main_torch.build_from_config``,
    with ``profile_steps=range(1, 2)``, ``LogAudioCallback`` and
    ``LogReferenceMix`` on one song: the trace's K2 and K2-bwd kernels and
    ``system.*`` ranges by ``utils/trace_ops.py``, the callbacks' files, the
    K2 launches of the reference render; (b) two Method-1 steps with
    ``comp_smoother="ballistics"`` at 4 x 8 x 262,144 on that model, and the
    console's gradients through the kernels against the plain versions'
    (one fixed cotangent); (c) ``device_timer`` and ``Meter`` on a K2 call;
    (d) the four ``scripts/*_torch.py`` of this slice as subprocesses, side
    by side, on [cli]'s files. Returns the launches of (a) and (b)."""
    import yaml

    import main_torch
    from diffmst_torch.callbacks import LogAudioCallback, LogReferenceMix
    from diffmst_torch.callbacks.audio import system_model_apply
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.data import read_audio
    from diffmst_torch.kernels import comp_fused
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.ops.compressor import _ballistics_coeff
    from diffmst_torch.train import System, SystemConfig
    from diffmst_torch.utils.config import load_config
    from diffmst_torch.utils.profiler import Meter, device_timer
    from diffmst_torch.utils.trace_ops import category_breakdown_from_trace, top_ops_from_trace

    phase_t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) a profiled, logged fit
    corpus, obs = tmp / "corpus", tmp / "observe"
    obs.mkdir()
    overlay = obs / "observe.yaml"
    overlay.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1, "num_sanity_val_steps": 0,
                    "check_val_every_n_epoch": 1, "enable_checkpointing": False},
        "data": {"init_args": {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
                               "num_examples_per_pass": 12, "num_train_passes": 1}}}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.chdir(root):
        system, _, trainer = main_torch.build_from_config(
            load_config([str(root / c) for c in CLI_CONFIGS] + [str(overlay)]))
    song = corpus / "val_song00"
    audio_dir, ref_dir, prof_dir = obs / "audio", obs / "refmix", obs / "profiles"
    refmix = LogReferenceMix([str(song)], [str(song / "keys_st.wav")], output_dir=str(ref_dir), length=WINDOW,
                             model_apply=system_model_apply, mix_console=system.mix_console)
    ref_k2 = []
    render_refmix = refmix.on_validation_end

    def counted_refmix(*args):
        before = read_counts()["K2"]
        render_refmix(*args)
        ref_k2.append(read_counts()["K2"] - before)

    refmix.on_validation_end = counted_refmix
    trainer.callbacks += [LogAudioCallback(output_dir=str(audio_dir), mix_console=system.mix_console), refmix]
    trainer.profile_steps, trainer.profile_dir = range(1, 2), str(prof_dir)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.chdir(root):
        trainer.fit()
    fit_s = time.perf_counter() - t0
    counts = read_counts()
    add(counts)
    n = _cli_numbers(out.getvalue())
    require(len(n["steps_per_sec"]) == 3 and all(np.isfinite(x) for x in n["losses"]),
            f"the observed fit: 3 logged steps, losses finite ({n})")
    t0 = time.perf_counter()
    device = top_ops_from_trace(str(prof_dir), top_n=10**6)
    host = top_ops_from_trace(str(prof_dir), top_n=10**6, device_substr="cpu")
    breakdown = category_breakdown_from_trace(str(prof_dir))
    read_s = time.perf_counter() - t0
    k2 = sum(r["occurrences"] for r in device if "CompressorOp" in r["op"])
    k2_bwd = sum(r["occurrences"] for r in device if "CompressorBackwardOp" in r["op"])
    ranges = {r["op"]: r for r in host if r["op"].startswith("system.")}
    traces = sorted(p.name for p in prof_dir.iterdir())
    line(f"[observe] (a) Trainer.fit, 3 steps at full width over [cli]'s corpus with profile_steps=range(1, 2):"
         f" {fit_s:.1f} s, [train] steps/s {n['steps_per_sec']}; launches {counts}; trace {traces}"
         f" ({sum(p.stat().st_size for p in prof_dir.iterdir())} bytes), read in {read_s:.1f} s;"
         f" K2 {k2} and K2-bwd {k2_bwd} kernels in it")
    for r in device[:10]:
        line(f"[observe] (a) top op {r['rank']:2d}: {r['total_ms']:9.3f} ms {r['pct_of_total']:5.1f}%"
             f" {r['occurrences']:5d}x {r['category']}: {r['op'][:90]}")
    line("[observe] (a) categories: " + "; ".join(
        f"{c['category']} {c['total_ms']:.3f} ms ({c['pct_of_total']}%, {c['occurrences']}x)" for c in breakdown))
    line("[observe] (a) ranges (host ms, occurrences): " + ", ".join(
        f"{k} {r['total_ms']:.1f} ({r['occurrences']}x)" for k, r in sorted(ranges.items())))
    require(k2 > 0 and k2_bwd > 0, f"the trace lists K2 and K2-bwd by name ({k2}, {k2_bwd})")
    require(all(f"system.{k}" in ranges for k in ("ref_mix", "model", "render", "loss", "backward", "optimizer")),
            f"the trace lists the system.* ranges ({sorted(ranges)})")
    audio_files = sorted(os.listdir(audio_dir))
    mix, _ = read_audio(str(ref_dir / "epoch0000_val_song00.wav"))
    line(f"[observe] (a) LogAudioCallback wrote {audio_files}; LogReferenceMix wrote {os.listdir(ref_dir)}"
         f" ({mix.shape[1]} samples), launching K2 {ref_k2} times")
    require("epoch0000_params.json" in audio_files and "epoch0000_ex0.wav" in audio_files,
            f"LogAudioCallback's files ({audio_files})")
    require(np.isfinite(mix).all() and np.abs(mix).max() > 0, "LogReferenceMix wrote a finite mix")
    require(len(ref_k2) == 1 and ref_k2[0] > 0, f"LogReferenceMix's render launched K2 ({ref_k2})")

    # (b) the ballistics smoother in a Method-1 step
    console = AdvancedMixConsole(SR, **CONSOLE_RANGES, comp_smoother="ballistics")
    sys_b = System(system.model.train(), console, MultiResolutionSTFTLoss(**MRSTFT), SystemConfig(),
                   generator=torch.Generator().manual_seed(1))
    batch = synth_batch(13)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = sys_b.effect_flags(0)
    walls = []
    for step in range(2):
        reset_counts()
        t0 = time.perf_counter()
        m = sys_b.train_step(batch, flags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = read_counts()
        add(counts)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        line(f"[observe] (b) ballistics step {step + 1}: {walls[-1]:.3f} s, loss {loss:.5f}, grad_norm {gn:.5g},"
             f" launches {counts}")
        require(np.isfinite(loss) and np.isfinite(gn), f"ballistics step {step + 1} loss and grad_norm finite")
        require(counts["ballistics"] == 4 and counts["K4-bwd"] == 2 and counts["K2"] == counts["K2-bwd"] == 0,
                f"ballistics step {step + 1}: 4 ballistics and 2 K4-bwd launches, no K2 ({counts})")
    with torch.no_grad():
        _, _, outs = sys_b.forward(batch, flags, True)
    tp, fp, mp = (t.detach() for t in outs["pred_params"])
    tracks_b = batch.tracks[..., HALF:]
    w = torch.randn(TRAIN_BS, 2, HALF, device="cuda", generator=torch.Generator("cuda").manual_seed(4))

    def console_grads():
        leaves = [t.clone().requires_grad_() for t in (tracks_b, tp, mp)]
        mix_ = console(leaves[0], leaves[1], fp, leaves[2], use_fx_bus=False).mix
        (mix_ * w).sum().backward()
        torch.cuda.synchronize()
        return [leaf.grad for leaf in leaves]

    reset_counts()
    got = console_grads()
    kernel_counts = read_counts()
    t0 = time.perf_counter()
    with plain_versions():
        reset_counts()
        want = console_grads()
        plain_counts = read_counts()
    plain_s = time.perf_counter() - t0
    rel = {name: float((g.double() - p.double()).norm() / p.double().norm())
           for name, g, p in zip(("tracks", "track_params", "master_params"), got, want)}
    line(f"[observe] (b) ballistics steps at {TRAIN_BS}x{TRAIN_TRACKS}x{WINDOW}: step 2 {1.0 / walls[1]:.3f} steps/s"
         f" ({walls[1]:.3f} s), step 1 {walls[0]:.3f} s; the console's gradients at the predicted parameters,"
         f" kernels vs plain versions on the card ({plain_s:.1f} s), of each tensor's norm: "
         + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
         + f"; launches {kernel_counts} (plain pass {plain_counts})")
    require(kernel_counts["ballistics"] == 2 and kernel_counts["K4-bwd"] == 2,
            f"the console's gradients ran the ballistics kernel and K4-bwd ({kernel_counts})")
    require(not any(plain_counts.values()), f"the plain pass launched no kernel ({plain_counts})")
    require(max(rel.values()) <= 1e-4, f"the ballistics console's gradients agree with the plain versions' ({rel})")
    del sys_b, system, trainer, batch, got, want

    # (c) device_timer and Meter on a K2 call at the track chain's shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(32, WINDOW, device="cuda", generator=gen)
    x = (x / x.abs().amax(dim=-1, keepdim=True)).contiguous()
    xd = torch.roll(x, 2048, dims=-1)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(32, device="cuda", generator=gen)  # noqa: E731
    thr, ratio, knee, alpha, makeup = u(-40, -6), u(1.5, 10), u(3, 12), _ballistics_coeff(u(1, 250), SR), u(0, 6)
    k2_call = lambda v: comp_fused.compressor_fused_gain(v, xd, thr, ratio, knee, alpha, makeup)  # noqa: E731
    sec = device_timer(k2_call, x, iters=20, reps=5)
    meter = Meter(audio_seconds_per_step=32 * WINDOW / SR, warmup=2)
    for _ in range(12):
        k2_call(x)
        torch.cuda.synchronize()
        meter.tick()
    summary = meter.summary()
    line(f"[observe] (c) K2 at 32x{WINDOW}: device_timer {sec * 1e3:.4f} ms an iteration (20 dependent calls,"
         f" each with the carry's scaling; best of 5), Meter p50 {summary['p50_ms']:.4f} ms and p90"
         f" {summary['p90_ms']:.4f} ms a synchronized call ({summary['steps_per_sec']:.1f} calls/s,"
         f" {summary['realtime_factor']:.1f}x realtime); [kernels]' median {k2_ms:.4f} ms")
    require(0 < sec < 1.0 and summary["p50_ms"] > 0, f"the instruments measured ({sec}, {summary})")

    # (d) the four scripts, side by side, on [cli]'s files; the U-Net demo on the card
    argv = {
        "compare_torch.py": [str(song / "keys_st.wav"), str(corpus / "train_song00" / "keys_st.wav"),
                             "--output_dir", str(obs / "compare")],
        "datasets_torch.py": ["--input_dir", str(song), "--output_dir", str(obs / "datasets"), "--sr", "48000"],
        "info_torch.py": ["--root", str(corpus)],
        "unet_separator_demo_torch.py": ["3", "2"],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(root / "scripts" / name), *args], cwd=obs,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, args in argv.items()}
    results = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            results[name] = stdout
            require(proc.returncode == 0, f"{name} exited {proc.returncode}:\n{stdout[-2000:]}\n{stderr[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    scripts_s = time.perf_counter() - t0
    demo = json.loads(results["unet_separator_demo_torch.py"].strip().splitlines()[-1])
    n_mono = len(list((obs / "datasets").rglob("*.wav")))
    census = [ln for ln in results["info_torch.py"].splitlines() if ln]
    line(f"[observe] (d) {', '.join(OBSERVE_SCRIPTS)} as subprocesses in {scripts_s:.1f} s: compare wrote"
         f" {sorted(p.name for p in (obs / 'compare').rglob('*.*'))}; datasets {n_mono} mono files at 48 kHz;"
         f" info {census}; U-Net demo on {demo['backend']}, {demo['steps']} steps in {demo['wall_s']} s,"
         f" held-out SI-SDR {demo['heldout_sisdr_baselines_db']} dB, trained {demo['heldout_sisdr_trained_db']}")
    require(any((obs / "compare").rglob("features.csv")), "compare_torch.py wrote its CSV")
    require(n_mono > 0 and any(ln.startswith("total audio") for ln in census), "datasets and info ran")
    require(demo["backend"] == "cuda" and all(np.isfinite(v) for v in demo["heldout_sisdr_baselines_db"].values()),
            f"the U-Net demo ran on the card ({demo})")
    line(f"[observe] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


# ------------------------------------------------------------------ fused

FUSED_K = 4  # Method-1 steps a CUDA graph replay (trainer.fused_steps)


def _clone(obj):
    """A copy of a nest of dicts, lists and tuples with each tensor cloned
    where it lies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _state_parts(system) -> dict:
    """The System's state in the parts [fused] compares: parameters,
    BatchNorm statistics, the optimizer's moments (and step tensors)."""
    opt = system.optimizer.state_dict()
    moments = ([v for st in opt["state"].values() for v in st.values() if isinstance(v, torch.Tensor)]
               if "state" in opt else opt["mu"] + opt["nu"])
    params = {id(p) for p in system.params}
    model = system.model
    return {"parameters": [p.detach() for p in model.parameters()],
            "statistics": [b for b in model.buffers() if id(b) not in params],
            "moments": moments}


def _fused_config(root: pathlib.Path, configs, name: str, **checks) -> dict:
    """One configuration's [fused] checks at full width, cuDNN
    deterministic (the MRSTFT frames overlap by half, so the STFT's
    backward adds two values a sample in either order alike, and eager
    steps are bitwise repeatable): ``groups`` x K eager steps run twice
    from one snapshot (eager's own spread), then the warm-up group and the
    capture, then ``groups`` replays of K from the same snapshot, held
    against the eager runs; the steps/s, capture time and peak memory of
    each; one replay traced where ``trace``. ``overrides`` replace fields of
    the SystemConfig; ``poison`` is the index of a batch given a NaN.
    Returns the launches and the rates."""
    torch.backends.cudnn.deterministic = True
    try:
        return _fused_checks(root, configs, name, **checks)
    finally:
        torch.backends.cudnn.deterministic = False


def _fused_system(root: pathlib.Path, configs, overrides=None):
    """The System of ``configs`` at full width, the learning rate on a
    cosine over 4K steps (each update its own lr), ``overrides`` on its
    SystemConfig; with [training]'s batch."""
    import dataclasses

    import main_torch
    from diffmst_torch.train.system import lr_schedule
    from diffmst_torch.utils.config import load_config

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.chdir(root):
        system, _, _ = main_torch.build_from_config(load_config([str(root / c) for c in configs]))
    system.config = dataclasses.replace(system.config, schedule="cosine", steps_per_epoch=4 * FUSED_K,
                                        max_epochs=1, **(overrides or {}))
    system.lr_at = lr_schedule(system.config)
    return system, synth_batch(31)


def _synced(fn):
    """(fn's result, wall s, peak allocated bytes), the card synchronized."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _counters(system) -> tuple:
    return system.step, system.updates, system.notfinite_count, system._mini_step


def _fused_checks(root: pathlib.Path, configs, name: str, overrides=None, poison=None, groups=2,
                  trace=True) -> dict:
    from diffmst_torch.train import Batch

    n = groups * FUSED_K
    system, base = _fused_system(root, configs, overrides)
    batches = [Batch(torch.roll(base.tracks, 4099 * i, dims=-1).cuda(), base.instrument_id, base.stereo_info,
                     base.track_padding.cuda(), base.ref_mix.cuda()) for i in range(n)]
    if poison is not None:
        batches[poison].tracks[0, 0, 0] = float("nan")
    return _replay_checks(system, batches, name, FUSED_K, groups, trace=trace,
                          expect=None if overrides else (n, n))


def _replay_checks(system, batches, name: str, k: int, groups: int, tag="[fused]", trace=True, warm=1,
                   distinct_lrs=True, expect=None) -> dict:
    """``groups`` x ``k`` steps of ``system`` over ``batches`` (one a step)
    from one snapshot, taken after ``warm`` eager steps (the optimizer's
    state, whole accumulations): eagerly twice (eager's own spread), then
    the warm-up group and the capture, then ``groups`` replays, held against
    the eager runs (see ``_fused_config``); ``expect`` the (step, updates)
    the replays must move by, ``distinct_lrs`` each update its own learning
    rate. Returns the launches and the rates."""
    from diffmst_torch.train.fused import FusedSteps
    from torch.profiler import ProfilerActivity, profile

    n = groups * k
    flags = system.effect_flags(0)
    steps = FusedSteps(system, flags, k)  # torch.optim.Adam becomes capturable
    launches = {}

    def add(counts):
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v

    reset_counts()
    for b in batches[:warm]:
        system.train_step(b, flags)  # the optimizer's state, before the snapshot
    start = _clone(system.state_dict())
    counters0 = _counters(system)
    lrs = [system.lr_at(system.updates + i) for i in range(n)]

    def eager():
        system.load_state_dict(start)
        losses, wall, peak = _synced(lambda: [system.train_step(b, flags)["loss"] for b in batches])
        return ([float(x) for x in losses], _clone(_state_parts(system)), system.generator.get_state(), wall, peak,
                _counters(system))

    runs = [eager(), eager()]
    system.load_state_dict(start)
    reserved_before = torch.cuda.memory_reserved()
    (_, first_s, capture_peak) = _synced(lambda: steps(batches[:k]))
    reserved = torch.cuda.memory_reserved()
    system.load_state_dict(start)

    def replays():
        got = []
        for g in range(groups):
            got.append([{key: v.clone() for key, v in m.items()} for m in steps(batches[g * k:(g + 1) * k])])
        return got

    replayed, fused_s, replay_peak = _synced(replays)
    losses = [float(m["loss"]) for group in replayed for m in group]
    (l0, s0, g0, eager_s, eager_peak, c0), (l1, s1, g1, eager_s2, _, c1) = runs

    def worst(got, a, b):
        """Per tensor: |got - a| and the eager spread |b - a|, of |a|
        (norms, NaN where a has NaN left out); the worst ratio of the error
        to max(2 x spread, 1e-6); inf where the NaNs differ."""
        ratio, err_max, spread_max = 0.0, 0.0, 0.0
        for x, y, z in zip(got, a, b):
            nan = y.isnan()
            if not (torch.equal(x.isnan(), nan) and torch.equal(z.isnan(), nan)):
                ratio = float("inf")
                continue
            x, y, z = (t.double().masked_fill(nan, 0.0) for t in (x, y, z))
            ref = max(float(y.norm()), 1e-30)
            err = float((x - y).norm()) / ref
            spread = float((z - y).norm()) / ref
            ratio = max(ratio, err / max(2.0 * spread, 1e-6))
            err_max, spread_max = max(err_max, err), max(spread_max, spread)
        return ratio, err_max, spread_max

    def loss_ratio(x, a, b):
        if np.isnan(a):
            return 0.0 if np.isnan(x) and np.isnan(b) else float("inf")
        return abs(x - a) / max(2.0 * abs(b - a), 1e-6 * abs(a))

    parts = _state_parts(system)
    figures = {part: worst(parts[part], s0[part], s1[part]) for part in parts}
    worst_loss = max(loss_ratio(x, a, b) for x, a, b in zip(losses, l0, l1))
    counters = _counters(system)
    moved = tuple(c - c0 for c, c0 in zip(counters[:2], counters0[:2]))
    line(f"{tag} {name}: per-step losses, eager {l0}, eager again {l1}, replayed {losses}; lr a step {lrs}")
    line(f"{tag} {name}: replay vs eager, of each tensor's norm (worst error, eager's worst spread, worst"
         f" error / max(2 x spread, 1e-6)): " + "; ".join(
             f"{part} {e:.3g}, {sp:.3g}, {r:.3g}" for part, (r, e, sp) in figures.items())
         + f"; losses {worst_loss:.3g}; generator state equal {torch.equal(system.generator.get_state(), g0)}"
         f" (eager runs {torch.equal(g0, g1)}); step and updates +{moved}; (step, updates, non-finite count,"
         f" mini-step) eager {c0}, {c1}, replayed {counters}")
    require(max(worst_loss, *(r for r, _, _ in figures.values())) <= 1.0,
            f"{name}: the replays within 2 x eager's spread or 1e-6 ({figures}, losses {worst_loss})")
    require(torch.equal(system.generator.get_state(), g0) and counters == c0 == c1,
            f"{name}: the generator and the counters after the replays ({counters}, eager {c0}, {c1})")
    require(expect is None or moved == expect, f"{name}: the step and updates moved by {expect} ({moved})")
    require(not distinct_lrs or len(set(lrs)) == n, f"{name}: each update its own learning rate ({lrs})")

    eager_rate, fused_rate = n / eager_s, n / fused_s
    line(f"{tag} {name}, cuDNN deterministic: sequential {eager_rate:.3f} steps/s ({eager_s:.3f} and"
         f" {eager_s2:.3f} s for {n} steps), fused {fused_rate:.3f} steps/s ({fused_s:.3f} s for {groups} replays"
         f" of {k}); the warm-up group and the capture {first_s:.3f} s (capture {steps.capture_s:.3f} s,"
         f" instantiate {steps.instantiate_s:.3f} s);"
         f" peak memory sequential {eager_peak / 2**30:.2f} GiB, warm-up and capture"
         f" {capture_peak / 2**30:.2f} GiB, replays {replay_peak / 2**30:.2f} GiB; reserved before the"
         f" warm-up {reserved_before / 2**30:.2f} GiB (the eager runs' cache), after the capture"
         f" {reserved / 2**30:.2f} GiB (the cache handed back before and after it), of which the graph's pool"
         f" {steps.pool_bytes / 2**30:.2f} GiB")
    out = dict(eager_rate=eager_rate, fused_rate=fused_rate)
    if trace:
        # one replay traced: K2 and K2-bwd from the card's records
        batch_group = batches[:k]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPIN_LEAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(batch_group)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        kernels = [e for e in prof.events() if e.device_type == cuda and SPIN_KERNEL not in e.name]
        k2 = sum("CompressorOp" in e.name for e in kernels)
        k2_bwd = sum("CompressorBackwardOp" in e.name for e in kernels)
        busy_us, end = 0.0, -np.inf  # the union of the records' intervals
        for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in kernels):
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        busy_ms = busy_us / 1e3
        launch_calls = sorted({e.name for e in prof.events() if e.device_type != cuda and "Graph" in e.name})
        span_ms = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
        out["busy"] = busy_ms / (traced_s * 1e3)
        line(f"{tag} {name}: one replay traced: {traced_s:.3f} s wall, the card busy {busy_ms:.1f} ms (the union"
             f" of its records; {100.0 * out['busy']:.1f}% of the wall, {100.0 * busy_ms / span_ms:.1f}%"
             f" of the {span_ms:.1f} ms from its first record to its last), {len(kernels)} records, K2 {k2} and"
             f" K2-bwd {k2_bwd} kernels ({4 * k} and {2 * k} expected); host calls {launch_calls}")
        require(k2 == 4 * k and k2_bwd == 2 * k,
                f"{name}: the traced replay's K2 and K2-bwd kernels ({k2}, {k2_bwd})")
    add(read_counts())
    steps.release()
    del steps, system, start, runs, replayed, parts
    return dict(out, launches=launches)


def _fused_shapes(root: pathlib.Path) -> dict:
    """(h) ``naive+tpu.yaml``, groups of K batches of 4 x 8 x 262,144, then
    4 x 8 x 131,072, then 262,144 again: from one snapshot, eager steps;
    then each shape's warm-up group and capture (the second graph in the
    first one's pool, its growth printed), then from the snapshot the three
    groups as replays, held against the eager steps bitwise (cuDNN
    deterministic). Returns the launches."""
    from diffmst_torch.train import Batch
    from diffmst_torch.train.fused import FusedSteps

    k = FUSED_K
    system, base = _fused_system(root, TPU_CONFIGS)
    full = [Batch(torch.roll(base.tracks, 4099 * i, dims=-1).cuda(), base.instrument_id, base.stereo_info,
                  base.track_padding.cuda(), base.ref_mix.cuda()) for i in range(2 * k)]
    half = [b._replace(tracks=b.tracks[..., :HALF].contiguous(), ref_mix=b.ref_mix[..., :HALF].contiguous())
            for b in full[k:]]
    groups = [full[:k], half, full[k:]]
    flags = system.effect_flags(0)
    steps = FusedSteps(system, flags, k)
    reset_counts()
    system.train_step(full[0], flags)
    start = _clone(system.state_dict())

    def eager():
        return [float(system.train_step(b, flags)["loss"]) for g in groups for b in g]

    want, eager_s, eager_peak = _synced(eager)
    state, gen, counters = _clone(_state_parts(system)), system.generator.get_state(), _counters(system)
    system.load_state_dict(start)
    reserved_before = torch.cuda.memory_reserved()
    _, first_s, _ = _synced(lambda: (steps(groups[0]), steps(groups[1])))
    reserved = torch.cuda.memory_reserved()
    system.load_state_dict(start)

    def replays():
        return [float(m["loss"]) for g in groups for m in steps(g)]

    got, fused_s, replay_peak = _synced(replays)
    launches = read_counts()
    parts = _state_parts(system)
    same = {part: all(torch.equal(x, y) for x, y in zip(parts[part], state[part])) for part in parts}
    first, second = steps.captures
    line(f"[fused] (h) naive+tpu.yaml, groups of {k} at 4 x 8 x 262,144, 131,072, then 262,144: eager losses {want},"
         f" replayed {got}; bitwise {same}, generator {torch.equal(system.generator.get_state(), gen)}, counters"
         f" {_counters(system)} (eager {counters})")
    line(f"[fused] (h) graphs: 262,144 captured in {first['capture_s']:.3f} s, its pool"
         f" {first['pool_growth'] / 2**30:.2f} GiB; 131,072 captured in {second['capture_s']:.3f} s into the same"
         f" pool, which grew by {second['pool_growth'] / 2**30:.2f} GiB (to {steps.pool_bytes / 2**30:.2f} GiB;"
         f" reserved {reserved_before / 2**30:.2f} GiB before the two warm-up groups, {reserved / 2**30:.2f} after);"
         f" sequential {3 * k / eager_s:.3f} steps/s ({eager_s:.3f} s), 3 replays {3 * k / fused_s:.3f} steps/s"
         f" ({fused_s:.3f} s), the two warm-up groups and captures {first_s:.3f} s; peak memory sequential"
         f" {eager_peak / 2**30:.2f} GiB, replays {replay_peak / 2**30:.2f} GiB")
    require(got == want and all(same.values()) and torch.equal(system.generator.get_state(), gen)
            and _counters(system) == counters, f"(h): the replays of two shapes against eager steps ({same})")
    steps.release()
    return launches


def phase_fused(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """``fused_steps`` (``diffmst_torch/train/fused.py``): K = 4 Method-1
    steps as one CUDA graph replay, at full width, for ``naive.yaml``
    (float32, ``torch.optim.Adam``, capturable) and ``naive+tpu.yaml``
    (bf16 compute, OptaxAdam with a bf16 first moment), each held against
    eager steps across a per-step learning rate (``_fused_config``); where
    the device decides which steps update, (f) ``naive.yaml`` with
    ``skip_nonfinite_updates: 2`` and a poisoned batch and (g)
    ``naive+tpu.yaml`` with ``accumulate_grad_batches: 3`` over three
    replays, held so too; (h) groups of two batch shapes, two graphs in one
    pool (``_fused_shapes``); then ``main_torch.py fit`` with
    ``trainer.fused_steps: 4`` over [cli]'s corpus, a subprocess
    (naive+tpu.yaml: 2 groups). Returns the phase's launches."""
    import yaml

    phase_t0 = time.perf_counter()
    launches = {}

    def add(counts):
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
        torch.cuda.empty_cache()

    naive = CLI_CONFIGS[:2] + CLI_CONFIGS[3:]
    rates = {}
    for name, configs, checks in (
            ("naive.yaml", naive, {}), ("naive+tpu.yaml", TPU_CONFIGS, {}),
            # the device decides which steps update: (f) a NaN in group 2's
            # second batch, dropped (torch.optim.Adam's update selected);
            # (g) groups that start 0, 1 and 2 steps into an accumulation
            ("(f) naive.yaml, skip_nonfinite_updates 2", naive,
             dict(overrides={"skip_nonfinite_updates": 2}, poison=FUSED_K + 1)),
            ("(g) naive+tpu.yaml, accumulate_grad_batches 3", TPU_CONFIGS,
             dict(overrides={"accumulate_grad_batches": 3}, groups=3, trace=False))):
        got = _fused_config(root, configs, name, **checks)
        rates[name] = got
        add(got["launches"])
    torch.backends.cudnn.deterministic = True
    try:
        add(_fused_shapes(root))
    finally:
        torch.backends.cudnn.deterministic = False
    base, masked = rates["naive.yaml"], rates["(f) naive.yaml, skip_nonfinite_updates 2"]
    line(f"[fused] (f) against naive.yaml in this run: replays {masked['fused_rate']:.3f} against"
         f" {base['fused_rate']:.3f} steps/s, {1e3 / masked['fused_rate'] - 1e3 / base['fused_rate']:+.1f} ms a step"
         f" (the masked update, and the poisoned step's NaN arithmetic); the card busy"
         f" {100.0 * masked['busy']:.1f}% against {100.0 * base['busy']:.1f}% of a traced replay")

    corpus = tmp / "corpus"
    p = tmp / "fused_fit.yaml"
    p.write_text(yaml.safe_dump({
        "trainer": {"max_epochs": 1, "log_every_n_steps": FUSED_K, "num_sanity_val_steps": 0,
                    "check_val_every_n_epoch": 1000, "enable_checkpointing": False, "fused_steps": FUSED_K},
        "data": {"init_args": {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
                               "num_examples_per_pass": 8 * FUSED_K, "num_train_passes": 1}}}))
    configs = [*(str(root / c) for c in TPU_CONFIGS[:2]), str(root / "configs/data/synthetic-8.yaml"),
               str(root / TPU_CONFIGS[2]), str(p)]
    out, wall = _run_cli(root, ["main_torch.py", "fit", *(a for c in configs for a in ("-c", c))],
                         "main_torch.py fit with trainer.fused_steps: 4")
    n = _cli_numbers(out)
    fused_lines = [ln for ln in out.splitlines() if ln.startswith("fused:")]
    line(f"[fused] main_torch.py fit on naive+tpu.yaml, trainer.fused_steps {FUSED_K}, {2 * FUSED_K} steps:"
         f" exit 0 in {wall:.1f} s; [train] steps/s {n['steps_per_sec']} (a line a group); losses {n['losses']};"
         f" {fused_lines}; peak card memory {n['peak']} bytes")
    require(len(n["steps_per_sec"]) == 2 and all(np.isfinite(x) for x in n["losses"]),
            f"the fused fit: 2 logged groups, losses finite ({n})")
    require(len(fused_lines) == 1, f"the fused fit captured one graph ({fused_lines})")
    line(f"[fused] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


# ------------------------------------------------------------------ mesh

MESH_STEPS = 2  # timed steps a rank, after the compared one


def _flat_grads(system) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in system.params])


def _running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))}


def _mesh_system(dev, mesh=None, sharded=False):
    """[training]'s System at full width, seeded as there (weights 0,
    generator 1); with ``sharded``, track-parallel over ``mesh``."""
    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    on = mesh if sharded else None
    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0), device=dev,
                                        bn_axis_name=("dp", "mp") if sharded else None)
    console = AdvancedMixConsole(SR, **CONSOLE_RANGES, device=str(dev), mesh=on)
    return System(model, console, MultiResolutionSTFTLoss(**MRSTFT), SystemConfig(),
                  generator=torch.Generator().manual_seed(1), device=dev, mesh=on)


def mesh_rank(ref_path: str) -> dict:
    """One rank of [mesh] (``diffmst_torch.parallel.launch``, two ranks on
    the one card over gloo): at dp = 2, then at dp = 1 x mp = 2 (the
    track-parallel System, console and BatchNorm), one Method-1 step on
    [training]'s batch from the seeded weights, held against the
    single-process step saved in ``ref_path``, then MESH_STEPS timed
    steps. Each step's kernel launches are this rank's."""
    from diffmst_torch import parallel
    from diffmst_torch.utils.device import use_full_float32

    use_full_float32()
    torch.backends.cudnn.deterministic = True
    dev = parallel.rank_device()
    ref = torch.load(ref_path, mmap=True)
    ref_grads = ref["grads"].to(dev)
    out = {"rank": torch.distributed.get_rank(), "device": str(dev)}
    for kind, (dp, mp) in (("dp", (2, 1)), ("mp", (1, 2))):
        mesh = parallel.make_mesh(dp, mp)
        system = _mesh_system(dev, mesh, sharded=mp > 1)
        if mp == 1:
            system.distribute(mesh)
        t0 = time.perf_counter()
        system.check_replicas()
        replicas_s = time.perf_counter() - t0
        batch = parallel.shard_batch(synth_batch(11), mesh)
        batch = type(batch)(*(t.to(dev) for t in batch))
        flags = system.effect_flags(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        metrics = system.gradients(batch, flags)
        torch.cuda.synchronize()
        first = read_counts()
        grads = _flat_grads(system)
        grad_rel = float(torch.linalg.vector_norm((grads - ref_grads).double())
                         / torch.linalg.vector_norm(ref_grads.double()))
        del grads
        stats_rel = max(float((v.double().cpu() - ref["stats"][k].double()).abs().max()
                              / ref["stats"][k].double().abs().max()) for k, v in _running_stats(system.model).items())
        system.apply_gradients(metrics["grad_norm"])
        system.step += 1
        walls, counts = [], [first]
        for _ in range(MESH_STEPS):
            reset_counts()
            t0 = time.perf_counter()
            m = system.train_step(batch, flags)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(read_counts())
            if not np.isfinite(float(m["loss"])):
                raise RuntimeError(f"check failed: [mesh] {kind} rank loss not finite")
        out[kind] = dict(mesh=dict(mesh.shape), coordinate=mesh.coordinate, loss=float(metrics["loss"]),
                         grad_norm=float(metrics["grad_norm"]), grad_rel=grad_rel, stats_rel=stats_rel,
                         counts=counts, walls=walls, peak=torch.cuda.max_memory_allocated(dev),
                         replicas_s=replicas_s, local_batch=tuple(batch.tracks.shape))
        del system, batch, metrics, m
        torch.cuda.empty_cache()
    return out


def _csv_train_losses(root: pathlib.Path, since: int):
    """The train rows' losses that ``main_torch.py`` logged into
    logs/metrics.csv after its first ``since`` rows, at full precision;
    and the row count."""
    import csv

    path = root / "logs" / "metrics.csv"
    rows = list(csv.DictReader(open(path))) if path.exists() else []
    return [float(r["loss"]) for r in rows[since:] if r["tag"] == "train"], len(rows)


# cuDNN deterministic for a bitwise comparison of two fits (the CLI leaves
# it to cuDNN); the command line as the user types it otherwise
DETERMINISTIC_CLI = ("import runpy, sys, torch; torch.backends.cudnn.deterministic = True; "
                     "sys.argv = sys.argv[1:]; runpy.run_path('main_torch.py', run_name='__main__')")


def phase_mesh(root: pathlib.Path, tmp: pathlib.Path) -> dict:
    """The device mesh (``diffmst_torch/parallel``) on the one card: (a) a
    single-process Method-1 step at [training]'s recipe (4 x 8 x 262,144,
    naive.yaml's 190.9 M parameters, cuDNN deterministic), its loss,
    grad_norm, gradients and BatchNorm running statistics kept; (b) dp = 2
    and (c) dp = 1 x mp = 2, two ranks on the card over gloo (NCCL refuses
    two ranks a device), each rank's first step held against (a), its K2
    and K2-bwd launches counted, then steps/s and peak memory a rank; (d)
    ``main_torch.py fit`` with ``trainer.devices: 2`` exits with JAX's
    message and starts no rank; (e) ``main_torch.py fit`` with
    ``trainer.mesh: {dp: 1}`` and ``trainer.fused_steps: 4`` (NCCL at one
    rank: the collectives inside the CUDA graph) against the same fit
    without the mesh, both cuDNN deterministic. Returns the phase's
    launches (the reference step's and every rank's)."""
    import yaml

    from diffmst_torch import parallel

    phase_t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    system = _mesh_system(torch.device("cuda"))
    batch = synth_batch(11)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = system.effect_flags(0)
    reset_counts()
    t0 = time.perf_counter()
    metrics = system.gradients(batch, flags)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    launches = dict(read_counts())
    ref = {"grads": _flat_grads(system).cpu(), "stats": {k: v.cpu() for k, v in _running_stats(system.model).items()},
           "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    torch.backends.cudnn.deterministic = False
    del system, batch, metrics
    torch.cuda.empty_cache()
    ref_path = tmp / "mesh_reference.pt"
    torch.save(ref, ref_path)
    line(f"[mesh] (a) one process: loss {ref['loss']:.7f}, grad_norm {ref['grad_norm']:.7g}, {ref_s:.3f} s,"
         f" launches {launches}; reserved after freeing {torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    ranks = parallel.launch(mesh_rank, 2, (str(ref_path),), backend="gloo")
    launch_s = time.perf_counter() - t0
    for kind, what in (("dp", "(b) dp = 2"), ("mp", "(c) dp = 1 x mp = 2")):
        for r in ranks:
            k = r[kind]
            steps_per_s = len(k["walls"]) / sum(k["walls"])
            line(f"[mesh] {what}, rank {r['rank']} at {k['coordinate']} on {r['device']} over gloo,"
                 f" its batch {k['local_batch']}: loss {k['loss']:.7f} ({abs(k['loss'] / ref['loss'] - 1):.3g} off),"
                 f" grad_norm {k['grad_norm']:.7g} ({abs(k['grad_norm'] / ref['grad_norm'] - 1):.3g} off), gradients"
                 f" {k['grad_rel']:.3g} of their norm off, running statistics {k['stats_rel']:.3g} off; steps"
                 f" 2-{1 + MESH_STEPS} {steps_per_s:.3f} steps/s ({', '.join(f'{w:.3f}' for w in k['walls'])} s),"
                 f" peak {k['peak'] / 2**30:.2f} GiB (max_memory_allocated); replicas checked in"
                 f" {k['replicas_s']:.3f} s; launches a step {k['counts']}")
            require(abs(k["loss"] / ref["loss"] - 1) <= 1e-4, f"[mesh] {what} rank {r['rank']}: loss within 1e-4")
            require(abs(k["grad_norm"] / ref["grad_norm"] - 1) <= 1e-3,
                    f"[mesh] {what} rank {r['rank']}: grad_norm within 1e-3")
            require(k["grad_rel"] <= 1e-3, f"[mesh] {what} rank {r['rank']}: gradients within 1e-3 of their norm")
            require(k["stats_rel"] <= 1e-4, f"[mesh] {what} rank {r['rank']}: running statistics within 1e-4")
            for i, c in enumerate(k["counts"]):
                require(c["K2"] == 4 and c["K2-bwd"] == 2,
                        f"[mesh] {what} rank {r['rank']} step {i + 1}: 4 K2 and 2 K2-bwd launches ({c})")
                for key, v in c.items():
                    launches[key] = launches.get(key, 0) + v
    line(f"[mesh] (b) and (c): two ranks, {launch_s:.1f} s from spawn to exit")

    corpus = tmp / "corpus"
    data = {"track_root_dirs": [str(corpus)], "metadata_files": [str(corpus / "meta.yaml")],
            "num_examples_per_pass": 8 * FUSED_K, "num_train_passes": 1}
    trainer = {"max_epochs": 1, "log_every_n_steps": FUSED_K, "num_sanity_val_steps": 0,
               "check_val_every_n_epoch": 1000, "enable_checkpointing": False, "fused_steps": FUSED_K}

    def overlay(name, **extra):
        p = tmp / name
        p.write_text(yaml.safe_dump({"trainer": {**trainer, **extra}, "data": {"init_args": data}}))
        return [a for c in [*(str(root / c) for c in CLI_CONFIGS), str(p)] for a in ("-c", c)]

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "main_torch.py", "fit", *overlay("mesh_devices.yaml", devices=2)],
                          cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    said = (proc.stderr.strip().splitlines() or [""])[-1]
    line(f"[mesh] (d) main_torch.py fit with trainer.devices: 2 on {torch.cuda.device_count()} card: exit"
         f" {proc.returncode} in {wall:.1f} s: {said!r}")
    require(proc.returncode != 0 and "trainer.devices=2 but only 1 present" in proc.stderr,
            "[mesh] (d) trainer.devices: 2 on one card exits non-zero with JAX's message")
    require("built:" not in proc.stdout and "[train]" not in proc.stdout, "[mesh] (d) no rank started")

    fits = {}
    for name, extra in (("without a mesh", {}), ("trainer.mesh: {dp: 1}", {"mesh": {"dp": 1}})):
        _, since = _csv_train_losses(root, 0)
        out, wall = _run_cli(root, ["-c", DETERMINISTIC_CLI, "main_torch.py", "fit",
                                    *overlay("mesh_fit.yaml", **extra)], f"main_torch.py fit, {name}")
        n = _cli_numbers(out)
        losses, _ = _csv_train_losses(root, since)
        fits[name] = losses
        fused_lines = [ln for ln in out.splitlines() if ln.startswith("fused:")]
        line(f"[mesh] (e) main_torch.py fit, {name}, trainer.fused_steps {FUSED_K}, {2 * FUSED_K} steps, cuDNN"
             f" deterministic: exit 0 in {wall:.1f} s; losses {losses}; [train] steps/s {n['steps_per_sec']};"
             f" {fused_lines}; peak card memory {n['peak']} bytes")
        require(len(losses) == 2 and all(np.isfinite(losses)), f"[mesh] (e) {name}: 2 logged groups, finite")
        require(len(fused_lines) == 1, f"[mesh] (e) {name}: one graph captured")
    a, b = fits.values()
    worst = max(abs(x / y - 1) for x, y in zip(b, a))
    line(f"[mesh] (e) a one-rank NCCL mesh against no mesh: losses bitwise equal: {a == b}; largest"
         f" relative difference {worst:.3g}")
    require(worst <= 1e-6, "[mesh] (e) the one-rank mesh fit's losses equal the fit's without a mesh")
    line(f"[mesh] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


# ------------------------------------------------------------------ convergence

CONV_STEPS = 150  # one epoch of the train demo, at logs/train_demo_tpu.json's lr and schedule
M2_K, M2_GROUPS = 6, 2  # Method 2: two replays of 6 steps, an accumulation of 2
S16_K = 8  # 16 tracks: one replay of 8 steps


def demo_scripts(root: pathlib.Path):
    """The port's demo scripts (``scripts/*_torch.py``), imported by name
    as they import each other: (train_demo, probe_floor, train_demo_method2,
    train_demo_16track)."""
    import importlib

    if str(root / "scripts") not in sys.path:
        sys.path.insert(0, str(root / "scripts"))
    return tuple(importlib.import_module(f"{n}_torch")
                 for n in ("train_demo", "probe_floor", "train_demo_method2", "train_demo_16track"))


def demo_batches(dm, n: int) -> list:
    """The first ``n`` batches of ``dm``'s training loader as ``Batch``es on
    the card, as the Trainer's prefetch makes them."""
    import itertools

    from diffmst_torch.train.trainer import _to_batch

    return [_to_batch(raw, torch.device("cuda")) for raw in itertools.islice(dm.train_dataloader(), n)]


def _learning(demo, floor) -> dict:
    """(a) and (b): the train demo's Trainer at full width, the probe set's
    baseline and oracle floors, the untrained probe, one epoch, the probe."""
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.train import Trainer

    dev = torch.device("cuda")
    loss_fn = MultiResolutionSTFTLoss()
    system = demo.build_system(dev, loss_fn, steps_per_epoch=CONV_STEPS, max_epochs=1, lr=1e-5, schedule="none")
    dm = demo.SyntheticDM(CONV_STEPS, device=dev)
    collect = demo._CollectVal()
    trainer = Trainer(system, dm, max_epochs=1, log_every_n_steps=10, check_val_every_n_epoch=1,
                      deterministic_val=True, enable_checkpointing=False, callbacks=[collect], seed=demo.SEED)
    launches = {}
    reset_counts()
    t0 = time.perf_counter()
    floors = floor.probe_floors(dm, system.mix_console, loss_fn, dm.n_probe)
    baseline = floors["equal_gain_sum_baseline"]
    untrained = trainer.validate()["loss"]
    anchor_s = time.perf_counter() - t0
    launches.update(read_counts())

    losses = []
    train_step = system.train_step

    def recording(batch, flags):  # every step's loss, kept on the card
        metrics = train_step(batch, flags)
        losses.append(metrics["loss"].detach())
        return metrics

    system.train_step = recording
    reset_counts()
    _, fit_s, peak = _synced(trainer.fit)
    fit_counts = read_counts()
    for key, v in fit_counts.items():
        launches[key] = launches.get(key, 0) + v
    trail = torch.stack(losses).float().cpu().numpy()
    probe = collect.losses
    sps = [h["steps_per_sec"] for h in trainer.history if "steps_per_sec" in h]
    line(f"[convergence] (a) naive+tpu.yaml at {'x'.join(map(str, dm.shape))}, fresh stems synthesized on the card"
         f" every step, lr 1e-5, schedule none: probe (4 held-out batches, deterministic validation) untrained"
         f" {untrained:.4f}, after {CONV_STEPS} steps {probe[-1]:.4f}; equal-gain-sum baseline {baseline:.4f};"
         f" curve {[round(x, 4) for x in probe]}")
    line(f"[convergence] (a) train loss every 10th step {[round(float(x), 4) for x in trail[::10]]}; first third"
         f" {trail[:CONV_STEPS // 3].mean():.4f}, last third {trail[-(CONV_STEPS // 3):].mean():.4f}; logged steps/s"
         f" {[round(x, 3) for x in sps]} (median {np.median(sps):.3f}); the fit {fit_s:.1f} s with its probe pass,"
         f" peak {peak / 2**30:.2f} GiB; baseline, floors and untrained probe {anchor_s:.1f} s; the fit's K2"
         f" {fit_counts['K2']} and K2-bwd {fit_counts['K2-bwd']} launches")
    line(f"[convergence] (b) oracle floors of the same probe set: half render {floors['floor_half_render_mean']:.4f},"
         f" clipped to +/-48 dB {floors['floor_half_render_clipped_mean']:.4f}, full render cropped"
         f" {floors['floor_full_render_crop_mean']:.3g}; the output fader needs up to {floors['max_abs_needed_db']} dB"
         f" (within range: {floors['output_fader_within_range']})")
    require(len(trail) == CONV_STEPS and bool(np.isfinite(trail).all()),
            f"(a) the loss finite at every one of the {CONV_STEPS} steps")
    require(len(probe) == 2 and probe[0] == untrained, f"(a) two probe passes, the first the untrained ({probe})")
    require(probe[-1] < untrained and probe[-1] < baseline,
            f"(a) the probe after the epoch ({probe[-1]:.4f}) below the untrained probe ({untrained:.4f}) and the"
            f" equal-gain-sum baseline ({baseline:.4f})")
    require(fit_counts["K2-bwd"] == 2 * CONV_STEPS and fit_counts["K2"] >= 4 * CONV_STEPS,
            f"(a) 4 K2 and 2 K2-bwd launches a step ({fit_counts})")
    require(floors["floor_half_render_clipped_mean"] < baseline, "(b) the clipped oracle floor below the baseline")
    require(abs(floors["floor_full_render_crop_mean"]) <= 1e-3, "(b) the full render's crop about 0")
    return launches


def phase_convergence(root: pathlib.Path) -> dict:
    """The convergence demos (``scripts/*_torch.py``) at full width on the
    card: (a) ``train_demo_torch``'s Trainer on ``naive+tpu.yaml``, 4 x 8 x
    262,144 with fresh stems synthesized on the card every step, lr 1e-5
    and no schedule: the untrained probe on 4 held-out batches, one epoch of
    150 sequential steps, the probe again, which must be below the untrained
    one and the equal-gain-sum baseline, the loss finite at every step; (b)
    ``probe_floor_torch``'s oracle floors of the same probe set (the clipped
    one below the baseline, the full render's crop about 0); (c)
    ``train_demo_method2_torch``'s recipe (Method 2, ``AudioFeatureLoss``,
    micro-batch 2 x an accumulation of 2): 12 steps as two replays of 6
    against the same steps run eagerly from one snapshot; (d)
    ``train_demo_16track_torch``'s (16 tracks, padded slots, the fx bus):
    one replay of 8 against 8 eager steps; (c) and (d) with cuDNN's and
    PyTorch's deterministic kernels, held as [fused] holds its replays.
    Returns the phase's launches."""
    phase_t0 = time.perf_counter()
    demo, floor, method2, track16 = demo_scripts(root)
    launches = _learning(demo, floor)
    torch.cuda.empty_cache()

    def add(counts):
        for key, v in counts.items():
            launches[key] = launches.get(key, 0) + v
        torch.cuda.empty_cache()

    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    # the feature loss's 32,768-point STFT overlaps 4 frames a sample: its
    # backward's index_add_ races but for its deterministic kernel
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        n = M2_K * M2_GROUPS
        system = method2.build(dev, n, 1)
        batches = demo_batches(method2.SyntheticUnpairedDM(n, device=dev), n)
        # the snapshot after one whole accumulation: the groups start at its offset 0, as in the demo's fit
        got = _replay_checks(system, batches, "(c) Method 2, AudioFeatureLoss, accumulation 2", M2_K, M2_GROUPS,
                             tag="[convergence]", trace=False, warm=method2.ACCUM, distinct_lrs=False,
                             expect=(n, n // method2.ACCUM))
        add(got["launches"])
        del system, batches
        system = track16.build(dev, S16_K, 1)
        dm = track16.Synthetic16DM(S16_K, device=dev)
        got = _replay_checks(system, demo_batches(dm, S16_K), "(d) 16 tracks (16, 12, 16, 10 real), the fx bus",
                             S16_K, 1, tag="[convergence]", trace=False, distinct_lrs=False, expect=(S16_K, S16_K))
        add(got["launches"])
        del system, dm
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    line(f"[convergence] the phase: {time.perf_counter() - phase_t0:.1f} s; launches {launches}")
    return launches


def kernel_entry(name, source, replaces, launches, k, **extra):
    """The kernel's entry of the JSON line, with the achieved TB/s of the
    bytes its function must move; the kernel launches and memsets a call,
    where [kernels] traced them."""
    per_call = {key: k[key] for key in ("cuda_launches_per_call", "memsets_per_call") if key in k}
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
                achieved_tb_s=k["achieved_tb_s"], max_rel_err=k["max_rel_err"], shape=k["shape"],
                **per_call, **extra)


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
    stream_walls, stream = phase_streaming(model)
    del model
    torch.cuda.empty_cache()
    system, batch, flags, train, train_rate = phase_training()
    phase_train_profile(system, batch, flags)
    del system, batch
    torch.cuda.empty_cache()
    causal = phase_training_causal()
    torch.cuda.empty_cache()
    (root / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cli_", dir=root / "build"))
    try:
        cli = phase_cli(root, tmp, train_rate)
        torch.cuda.empty_cache()
        feature = phase_feature_loss(root, tmp)
        torch.cuda.empty_cache()
        param_est = phase_param_est(root, tmp)
        torch.cuda.empty_cache()
        evaluation = phase_eval(root, tmp)
        torch.cuda.empty_cache()
        recipe = phase_tpu_recipe(root, tmp)
        torch.cuda.empty_cache()
        observe = phase_observe(root, tmp, stats["compressor_fused_gain"]["ms"])
        torch.cuda.empty_cache()
        fused = phase_fused(root, tmp)
        torch.cuda.empty_cache()
        mesh = phase_mesh(root, tmp)
        torch.cuda.empty_cache()
        convergence = phase_convergence(root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    scan_cu, comp_cu, iir_cu, ball_cu = ("diffmst_torch/kernels/csrc/scan1p.cu",
                                         "diffmst_torch/kernels/csrc/comp_fused.cu",
                                         "diffmst_torch/kernels/csrc/iir_fused.cu",
                                         "diffmst_torch/kernels/csrc/ballistics.cu")
    serving = {k: sum(c[k] for c in stream) for k in stream[0]}
    serving["K1"] += k1_launches
    serving["K2"] += k2_launches
    training = {k: train.get(k, 0) + causal[k] for k in causal}

    def entry(key, name, source, replaces, **extra):
        """Launches: the serving requests (K2's three, K1's "scan" render,
        the three streaming ones), the training steps (four, then two
        causal ones), the CLI's steps, [feature-loss]'s steps and fx-bus
        requests, [param-est]'s remixes, [eval]'s requests, online
        iterations and exported requests, [tpu-recipe]'s steps and bf16
        request, [observe]'s profiled fit and ballistics steps, and
        [fused]'s eager steps and graph replays, [mesh]'s steps (the
        single-process one and each rank's), and [convergence]'s probes,
        floors, fit, eager steps and replays."""
        total = (serving[key] + training[key] + cli[key] + feature.get(key, 0) + param_est.get(key, 0)
                 + evaluation.get(key, 0) + recipe.get(key, 0) + observe.get(key, 0) + fused.get(key, 0)
                 + mesh.get(key, 0) + convergence.get(key, 0))
        return kernel_entry(name, source, replaces, total, stats[name],
                            launches_serving=serving[key], launches_training=training[key],
                            launches_cli=cli[key], launches_feature_loss=feature.get(key, 0),
                            launches_param_est=param_est.get(key, 0), launches_eval=evaluation.get(key, 0),
                            launches_tpu_recipe=recipe.get(key, 0), launches_observe=observe.get(key, 0),
                            launches_fused=fused.get(key, 0), launches_mesh=mesh.get(key, 0),
                            launches_convergence=convergence.get(key, 0), on_path=True, **extra)

    kernels = [
        entry("K1", "onepole_core", scan_cu, "diffmst_tpu/kernels/scan1p.py:111"),
        entry("K2", "compressor_fused_gain", comp_cu, "diffmst_tpu/kernels/comp_fused.py:98"),
        entry("K1-bwd", "onepole_core_backward", scan_cu,
              "diffmst_tpu/kernels/scan1p.py:145 (onepole_scan VJP, :142-150)"),
        # K4's forward is on no path (no smoother uses it); its backward is
        # the ballistics smoother's
        kernel_entry("onepole_core_per_sample", scan_cu,
                     "diffmst_tpu/kernels/scan1p.py:111 (per-sample alpha, onepole_scan_tv:160)",
                     serving["K4"] + training["K4"] + mesh.get("K4", 0) + convergence.get("K4", 0),
                     stats["onepole_core_per_sample"], launches_mesh=mesh.get("K4", 0),
                     launches_convergence=convergence.get("K4", 0), on_path=False),
        entry("K4-bwd", "onepole_core_backward_per_sample", scan_cu,
              "diffmst_tpu/kernels/scan1p.py:183 (onepole_scan_tv VJP, :176-187)"),
        entry("ballistics", "ballistics", ball_cu,
              "diffmst_tpu/ops/compressor.py:161 (_smooth_ballistics, lax.scan)",
              latency_bound_ms=stats["ballistics"]["latency_bound_ms"],
              ms_recording=stats["ballistics"]["ms_recording"], backward_ms=stats["ballistics"]["backward_ms"]),
        entry("K2-bwd", "compressor_fused_backward", comp_cu,
              "diffmst_tpu/kernels/comp_fused.py:167 (compressor_fused_gain VJP, :167-176)"),
        entry("K3", "release_min_scan", scan_cu,
              "diffmst_tpu/kernels/scan1p.py:253 (minscan_core:236, release_min_scan:270)"),
        entry("K3-bwd", "release_min_scan_backward", scan_cu,
              "diffmst_tpu/kernels/scan1p.py:294 (release_min_scan VJP, :294-297)"),
        entry("K5", "sosfilt", iir_cu,
              "diffmst_tpu/kernels/iir_fused.py:128 (_core:120, sosfilt_pallas:144)",
              pass_ms=stats["sosfilt"]["pass_ms"], stages_rel_err=stats["sosfilt"]["stages_rel_err"],
              ms_with_stages_32x131072=stats["sosfilt"]["ms_with_stages_32x131072"]),
        entry("K5-bwd", "sosfilt_backward", iir_cu,
              "diffmst_tpu/kernels/iir_fused.py:167 (sosfilt_pallas VJP, :167-170)",
              pass_ms=stats["sosfilt_backward"]["pass_ms"]),
    ]
    for k in kernels:
        require(k["launches"] > 0 or not k["on_path"], f"{k['name']} launched on its path")
    line(f"[serving] realtime factors {', '.join(f'{SONG_S / w:.1f}x' for w in walls)}"
         f" for {SONG_S:.0f} s, {N_TRACKS}-track songs; streaming with the causal console"
         f" {', '.join(f'{SONG_S / w:.1f}x' for w in stream_walls)}")
    line(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
