#!/usr/bin/env python3
"""Time the port's K5 (``diffmst_torch/kernels/iir_fused.py``) on one CUDA
card, by pass, at the console's shapes: the forward, or with ``--backward``
the backward.

    python3 scripts/time_sosfilt_cuda.py [CHECKOUT] [LABEL] [--backward]

CHECKOUT (default: this script's repository) is the root of a checkout whose
kernels are built and timed, so that two versions of ``csrc/iir_fused.cu``,
each in its own copy of the repository, can be compared in one run on one
card (A, B, B, A). The forward: for 32 and 8 rows of 262,144 samples and 32
rows of 131,072, the median device time of ``sosfilt`` without stages and
of ``_launch`` with them, the three passes' times (``chip_smoke.py``'s
``sosfilt_passes``) and the largest distance from the plain version, of its
peak. The backward: for 32 and 8 rows of 131,072 samples (the causal
training step's track and master EQs), on the stages of the checkout's own
forward, the median device time of ``sosfilt_backward``, its passes' times
where the checkout's ``chip_smoke.py`` has ``sosfilt_backward_passes``, and
the largest distances of dx and of the 30 sums from the plain version, each
of its max-abs. EQ sections are drawn over the console's ranges from seed 0.
"""

from __future__ import annotations

import pathlib
import sys


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--backward"]
    backward = len(args) < len(sys.argv) - 1
    here = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(args[0]).resolve() if args else here
    label = args[1] if len(args) > 1 else root.name
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_sosfilt_cuda: no CUDA device")
    import chip_smoke as cs
    from diffmst_torch.kernels import iir_fused

    if not pathlib.Path(iir_fused.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"time_sosfilt_cuda: imported {iir_fused.__file__}, not from {root}")
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB, over the L2

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

    shapes = ((32, 131072), (8, 131072)) if backward else ((32, 262144), (8, 262144), (32, 131072))
    for rows, t in shapes:
        gen = torch.Generator(device=dev).manual_seed(0)
        b, a = cs.eq_sections(rows, gen)
        x = torch.randn(rows, t, device=dev, generator=gen)
        coef = iir_fused._coef_rows(b, a)
        if backward:
            y, stages = iir_fused._launch(x, coef)
            dy = torch.randn(rows, t, device=dev, generator=gen)
            bwd = iir_fused.sosfilt_backward
            ms = cs.time_ms(lambda: bwd(x, stages, y, coef, dy), flush)
            passes = (cs.sosfilt_backward_passes(x, stages, y, coef, dy, flush)
                      if hasattr(cs, "sosfilt_backward_passes") else {})
            dx, dcoef = bwd(x, stages, y, coef, dy)
            dx_p, dcoef_p = iir_fused.sosfilt_backward_plain(x, stages, y, coef, dy)
            err = rel(dx, dx_p)
            err_sums = max(rel(dcoef[s, k], dcoef_p[s, k]) for s in range(6) for k in range(5))
            print(f"{label} backward {rows}x{t}: {ms:.4f} ms;"
                  + "".join(f" {k} {v:.4f} ms," for k, v in passes.items())
                  + f" dx {err:.3g}, sums {err_sums:.3g} off the plain version", flush=True)
            continue
        ms = cs.time_ms(lambda: iir_fused.sosfilt(x, b, a), flush)
        ms_stages = cs.time_ms(lambda: iir_fused._launch(x, coef), flush)
        passes = cs.sosfilt_passes(x, coef, flush)
        y, y_plain = iir_fused.sosfilt(x, b, a), iir_fused.sosfilt_plain(x, b, a)
        err = rel(y, y_plain)
        print(f"{label} {rows}x{t}: {ms:.4f} ms, {ms_stages:.4f} ms with stages;"
              + ", ".join(f" {k} {v:.4f} ms" for k, v in passes.items())
              + f"; {err:.3g} of the peak off the plain version", flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
