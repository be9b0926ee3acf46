#!/usr/bin/env python3
"""Time the port's K2 (``diffmst_torch/kernels/comp_fused.py``) and its
backward on one CUDA card at the console's shapes.

    python3 scripts/time_compressor_cuda.py [CHECKOUT] [LABEL] [--train-steps N]

CHECKOUT (default: this script's repository) is the root of a checkout whose
kernels are built and timed, so that two versions of ``csrc/comp_fused.cu``,
each in its own copy of the repository, can be compared in one run on one
card: run it for A, B, B, A in one command. It times K2 at 32 and 8 rows of
262,144 samples (lookahead 2048 and 1024, the track and master chains) and
at 32 x 131,072 writing the envelope (the forward of a training step), and
K2's backward at 32 and 8 x 131,072. For each it prints the median device
time (``chip_smoke.time_ms`` of the checkout: 20 calls, L2 overwritten
before each), the achieved TB/s of the bytes the function must move, and the
largest distance from the plain version: of the audio for the forward, and
of each output's max-abs for the backward (dx, dx_delayed, the five sums).
Inputs are drawn as ``chip_smoke.py`` draws them, from seed 0. With
``--train-steps N`` it then runs the checkout's ``chip_smoke.py`` training
phase with N Method-1 steps at the reference recipe (compressor "auto": K2
and its backward, 4 and 2 launches a step), which prints each step's wall
time: the end-to-end effect of K2 on the step.
"""

from __future__ import annotations

import pathlib
import sys


def main() -> int:
    args = sys.argv[1:]
    steps = 0
    if "--train-steps" in args:
        i = args.index("--train-steps")
        steps = int(args[i + 1])
        del args[i : i + 2]
    here = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(args[0]).resolve() if args else here
    label = args[1] if len(args) > 1 else root.name
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_compressor_cuda: no CUDA device")
    import chip_smoke as cs
    from diffmst_torch.kernels import comp_fused
    from diffmst_torch.ops.compressor import _ballistics_coeff

    if not pathlib.Path(comp_fused.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_compressor_cuda: imported {comp_fused.__file__}, not from {root}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, over the L2
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(rows, t, lookahead):
        env = torch.linspace(0.02, 1.0, t, device=dev)
        x = torch.randn(rows, t, device=dev, generator=gen) * env
        x = (x / x.abs().amax(dim=-1, keepdim=True)).contiguous()
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(rows, device=dev, generator=gen)  # noqa: E731
        thr, ratio, attack, knee, makeup = (u(-40.0, -6.0), u(1.5, 10.0), u(1.0, 250.0),
                                            u(3.0, 12.0), u(0.0, 6.0))
        p = comp_fused._param_rows(thr, ratio, knee, _ballistics_coeff(attack, cs.SR), makeup)
        return x, torch.roll(x, lookahead, dims=-1), p.contiguous()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()

    def report(what, rows, t, ms, bytes_a_sample, err):
        tbs = rows * t * bytes_a_sample / (ms * 1e-3) / 1e12
        print(f"{label} {what} {rows}x{t}: {ms:.4f} ms, {tbs:.3f} TB/s"
              f" ({bytes_a_sample} bytes a sample); {err}", flush=True)

    for rows, lookahead in ((32, 2048), (8, 1024)):
        x, xd, p = inputs(rows, 262144, lookahead)
        ms = cs.time_ms(lambda: comp_fused._launch(x, xd, p, 1e-8, envelope=False), flush)
        out, _ = comp_fused._launch(x, xd, p, 1e-8, envelope=False)
        out_p, _ = comp_fused._forward_plain(x, xd, p, 1e-8)
        err = (out - out_p).abs().max().item()
        report("K2", rows, 262144, ms, 12, f"max_abs {err:.3g} off the plain version")

    x, xd, p = inputs(32, 131072, 2048)
    ms = cs.time_ms(lambda: comp_fused._launch(x, xd, p, 1e-8, envelope=True), flush)
    out, env = comp_fused._launch(x, xd, p, 1e-8, envelope=True)
    out_p, env_p = comp_fused._forward_plain(x, xd, p, 1e-8)
    report("K2 with the envelope", 32, 131072, ms, 16, f"out {rel(out, out_p):.3g}, envelope"
           f" {rel(env, env_p):.3g} of their max-abs off the plain version")

    bwd = comp_fused.compressor_fused_backward
    for rows, lookahead in ((32, 2048), (8, 1024)):
        x, xd, p = inputs(rows, 131072, lookahead)
        _, env = comp_fused._forward_plain(x, xd, p, 1e-8)
        dy = torch.randn(rows, 131072, device=dev, generator=gen)
        ms = cs.time_ms(lambda: bwd(x, xd, p, env, dy), flush)
        got = bwd(x, xd, p, env, dy)
        want = comp_fused.compressor_fused_backward_plain(x, xd, p, env, dy)
        sums = max(rel(got[2][k], want[2][k]) for k in range(5))
        report("K2-bwd", rows, 131072, ms, 24,
               f"dx {rel(got[0], want[0]):.3g}, dx_delayed {rel(got[1], want[1]):.3g},"
               f" sums {sums:.3g} of their max-abs off the plain version")
    if steps:
        del x, xd, p, env, dy, got, want, flush
        torch.cuda.empty_cache()
        cs.phase_device()  # TF32 off, as in chip_smoke.py
        cs.TRAIN_STEPS = steps
        cs.phase_training()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
