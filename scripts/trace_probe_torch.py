"""Which of a short call's device records a torch.profiler trace keeps.

Traces one call of K4 (a memset and a kernel) and one of the ballistics
kernel (a kernel alone), at once and then after each of ``--pauses``
pauses with no trace running, led by 0, 8 and 64 spin kernels that finish
before the call. For each trace it prints, as a JSON line, the spin
kernels' records kept, the call's records on the card, the runtime calls
that enqueued the call's work (``cudaLaunchKernel``, ``cudaMemsetAsync``)
and how far the call's first kernel starts from its launch call.
``chip_smoke.py``'s one-call checks lead their traces with spin kernels
because of what this shows on an H100: a trace begun after a pause loses
the first few records of the card's activity and keeps the runtime calls.

    python3 scripts/trace_probe_torch.py [--pause 15] [--pauses 3] [--rows 32] [--samples 262144]

It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

SPIN_KERNEL = "spin_kernel"  # the kernel of torch.cuda._sleep
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemset", "cudaMemcpy")


def trace_call(fn, lead: int) -> dict:
    """The device records and runtime calls of one traced call of ``fn``,
    led by ``lead`` spin kernels."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == cuda]
    record = [e for e in device if SPIN_KERNEL not in e.name]
    calls = [e for e in events if e.device_type != cuda and e.name.startswith(RUNTIME_CALLS)][lead:]
    kernels = [e for e in record if not e.name.startswith(("Memset", "Memcpy"))]
    launches = [e for e in calls if e.name.startswith("cudaLaunchKernel")]
    offset_us = kernels[0].time_range.start - launches[0].time_range.start if kernels and launches else None
    return {
        "spin_kept": len(device) - len(record),
        "device": [e.name[:40] for e in record],
        "runtime": [e.name for e in calls],
        "kernel_after_launch_us": offset_us,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pause", type=float, default=15.0, help="seconds with no trace running")
    ap.add_argument("--pauses", type=int, default=3)
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--samples", type=int, default=262144)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe_torch: no CUDA device")

    from diffmst_torch.kernels import scan1p, smoother
    from diffmst_torch.ops.compressor import _ballistics_coeff

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, t = args.rows, args.samples
    g = (-20.0 * torch.rand(rows, t, device=dev, generator=gen)).contiguous()
    attack = _ballistics_coeff(1.0 + 19.0 * torch.rand(rows, device=dev, generator=gen), 44100.0).contiguous()
    release = _ballistics_coeff(50.0 + 250.0 * torch.rand(rows, device=dev, generator=gen), 44100.0).contiguous()
    a = _ballistics_coeff(1.0 + 249.0 * torch.rand(rows, t, device=dev, generator=gen), 44100.0).contiguous()
    b = ((1.0 - a) * g).contiguous()
    calls = {
        "K4": lambda: scan1p.onepole_core(b, a),
        "ballistics": lambda: smoother.ballistics(g, attack, release),
    }
    for fn in calls.values():  # built, loaded and run once before any trace
        fn()
    torch.cuda.synchronize()
    for pause in (0.0, *[args.pause] * args.pauses):
        time.sleep(pause)
        for lead in (0, 8, 64):
            for name, fn in calls.items():
                row = {"pause_s": pause, "spin_kernels": lead, "call": name, **trace_call(fn, lead)}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
