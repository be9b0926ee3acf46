#!/usr/bin/env python3
"""Time the port's K1, K3 and K4 (``diffmst_torch/kernels/scan1p.py``) and
their backward kernels on one CUDA card at the console's shapes.

    python3 scripts/time_scan1p_cuda.py [CHECKOUT] [LABEL] [--causal-steps N]

CHECKOUT (default: this script's repository) is the root of a checkout whose
kernels are built and timed, so that two versions of ``csrc/scan1p.cu``,
each in its own copy of the repository, can be compared in one run on one
card: run it for A, B, B, A in one command. It times K1 (the one-pole with a
row's alpha: attacks of 1-250 ms on the compressor's gains in dB) and K3
(the release min-scan: releases of 10-250 ms) at 32 and 8 rows of 262,144
samples, the serving shapes, and K1's and K3's backward kernels at 32 and
8 rows of 131,072, the training shapes; then K4 (the one-pole with a
per-sample alpha: attacks of 1-250 ms drawn per sample) at 32 and 8 rows
of 262,144 and its backward at 32 and 8 rows of 131,072, whose inputs are
drawn after the others', so that theirs stay those of earlier versions of
this script. For each it prints the median device time
(``chip_smoke.time_ms`` of the checkout: 20 calls, L2 overwritten before
each), the achieved TB/s of the bytes the function must move, and the
largest distance from the plain version: in dB for the forward kernels, of
each output's max-abs for the backward ones. Inputs are drawn as
``chip_smoke.py`` draws them, from seed 0. With ``--causal-steps N`` it then
runs N Method-1 steps at the reference recipe with the causal console (K3,
K1 and K5 forward and backward), built as the checkout's ``chip_smoke.py``
phase [training-causal] builds them, and prints each step's wall time and
the median of steps 2 to N: the end-to-end effect of K1 and K3 on the step.
"""

from __future__ import annotations

import pathlib
import sys
import time


def causal_steps(cs, steps: int, label: str) -> None:
    """``steps`` causal Method-1 steps at the reference recipe, as
    ``chip_smoke.phase_training_causal`` runs them."""
    import numpy as np
    import torch

    from diffmst_torch.console import AdvancedMixConsole
    from diffmst_torch.losses import MultiResolutionSTFTLoss
    from diffmst_torch.models import MixStyleTransferModel
    from diffmst_torch.train import System, SystemConfig

    cs.phase_device()  # TF32 off, as in chip_smoke.py
    model = MixStyleTransferModel.build(generator=torch.Generator().manual_seed(0))
    console = AdvancedMixConsole(cs.SR, **cs.CONSOLE_RANGES, **cs.CAUSAL)
    system = System(model, console, MultiResolutionSTFTLoss(**cs.MRSTFT), SystemConfig(),
                    generator=torch.Generator().manual_seed(1))
    batch = cs.synth_batch(12)
    batch = type(batch)(*(t.cuda() for t in batch))
    flags = system.effect_flags(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for step in range(steps):
        t0 = time.perf_counter()
        m = system.train_step(batch, flags)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"{label} causal step {step + 1}: {walls[-1]:.4f} s, loss {float(m['loss']):.5f}",
              flush=True)
    if steps > 1:
        print(f"{label} causal steps 2-{steps}: median {float(np.median(walls[1:])):.4f} s,"
              f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def main() -> int:
    args = sys.argv[1:]
    steps = 0
    if "--causal-steps" in args:
        i = args.index("--causal-steps")
        steps = int(args[i + 1])
        del args[i : i + 2]
    here = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(args[0]).resolve() if args else here
    label = args[1] if len(args) > 1 else root.name
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_scan1p_cuda: no CUDA device")
    import chip_smoke as cs
    from diffmst_torch.kernels import scan1p
    from diffmst_torch.ops.compressor import _ballistics_coeff

    if not pathlib.Path(scan1p.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_scan1p_cuda: imported {scan1p.__file__}, not from {root}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, over the L2
    gen = torch.Generator(device=dev).manual_seed(0)

    def gains(rows, t):
        """The compressor's gains in dB of peak-normalized audio, with attack
        (K1) and release (K3) coefficients."""
        env = torch.linspace(0.02, 1.0, t, device=dev)
        x = torch.randn(rows, t, device=dev, generator=gen) * env
        x = x / x.abs().amax(dim=-1, keepdim=True)
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(rows, device=dev, generator=gen)  # noqa: E731
        thr, ratio, attack, knee, release = (u(-40.0, -6.0), u(1.5, 10.0), u(1.0, 250.0),
                                             u(3.0, 12.0), u(10.0, 250.0))
        g = cs._static_gain_db(x, thr, ratio, knee).contiguous()
        return g, _ballistics_coeff(attack, cs.SR).contiguous(), _ballistics_coeff(release, cs.SR).contiguous()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()

    def report(what, rows, t, ms, bytes_a_sample, err):
        tbs = rows * t * bytes_a_sample / (ms * 1e-3) / 1e12
        print(f"{label} {what} {rows}x{t}: {ms:.4f} ms, {tbs:.3f} TB/s"
              f" ({bytes_a_sample} bytes a sample); {err}", flush=True)

    for rows in (32, 8):
        g, a1, a3 = gains(rows, 262144)
        b = ((1.0 - a1)[:, None] * g).contiguous()
        ms = cs.time_ms(lambda: scan1p.onepole_core(b, a1), flush)
        err = (scan1p.onepole_core(b, a1) - scan1p.onepole_core_plain(b, a1)).abs().max().item()
        report("K1", rows, 262144, ms, 8, f"max_abs {err:.3g} dB off the plain version")
        ms = cs.time_ms(lambda: scan1p.release_min_scan(g, a3), flush)
        err = (scan1p.release_min_scan(g, a3) - scan1p.release_min_scan_plain(g, a3)).abs().max().item()
        report("K3", rows, 262144, ms, 8, f"max_abs {err:.3g} dB off the plain version")

    for rows in (32, 8):
        g, a1, a3 = gains(rows, 131072)
        dy = torch.randn(rows, 131072, device=dev, generator=gen)
        y1 = scan1p.onepole_core(((1.0 - a1)[:, None] * g).contiguous(), a1)
        ms = cs.time_ms(lambda: scan1p.onepole_core_backward(dy, a1, y1), flush)
        got = scan1p.onepole_core_backward(dy, a1, y1)
        want = scan1p.onepole_core_backward_plain(dy, a1, y1)
        report("K1-bwd", rows, 131072, ms, 12, f"db {rel(got[0], want[0]):.3g}, dalpha"
               f" {rel(got[1], want[1]):.3g} of their max-abs off the plain version")
        y3 = scan1p.release_min_scan(g, a3)
        ms = cs.time_ms(lambda: scan1p.release_min_scan_backward(dy, g, a3, y3), flush)
        got = scan1p.release_min_scan_backward(dy, g, a3, y3)
        want = scan1p.release_min_scan_backward_plain(dy, g, a3, y3)
        report("K3-bwd", rows, 131072, ms, 16, f"dg {rel(got[0], want[0]):.3g}, dalpha"
               f" {rel(got[1], want[1]):.3g} of their max-abs off the plain version")
    for rows, t in ((32, 262144), (8, 262144), (32, 131072), (8, 131072)):
        g, _, _ = gains(rows, t)
        a4 = _ballistics_coeff(1.0 + 249.0 * torch.rand(rows, t, device=dev, generator=gen), cs.SR)
        b4 = ((1.0 - a4) * g).contiguous()
        if t == 262144:
            ms = cs.time_ms(lambda: scan1p.onepole_core(b4, a4), flush)
            err = (scan1p.onepole_core(b4, a4) - scan1p.onepole_core_plain(b4, a4)).abs().max().item()
            report("K4", rows, t, ms, 12, f"max_abs {err:.3g} dB off the plain version")
            continue
        dy = torch.randn(rows, t, device=dev, generator=gen)
        y4 = scan1p.onepole_core(b4, a4)
        ms = cs.time_ms(lambda: scan1p.onepole_core_backward(dy, a4, y4), flush)
        got = scan1p.onepole_core_backward(dy, a4, y4)
        want = scan1p.onepole_core_backward_plain(dy, a4, y4)
        report("K4-bwd", rows, t, ms, 20, f"db {rel(got[0], want[0]):.3g}, dalpha"
               f" {rel(got[1], want[1]):.3g} of their max-abs off the plain version")
    if steps:
        del g, a1, a3, a4, b4, dy, y1, y3, y4, got, want, flush
        torch.cuda.empty_cache()
        causal_steps(cs, steps, label)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
