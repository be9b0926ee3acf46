"""What a fused-steps CUDA graph holds in card memory, for several K.

Builds the Method-1 System of a model config at full width (seeded random
weights), runs one eager step, then for each K of ``--ks`` a
``FusedSteps`` group (the warm-up group and the capture), one replay and
``release()``. After each it prints the caching allocator's segments
(``torch.cuda.memory._snapshot()``), split into the graph's private pool
and the rest: their count, the bytes they reserve, the bytes allocated in
them. The batch is 4 x 8 x 262,144 samples of seeded noise at about
-48 dBFS, cuDNN deterministic.

    python3 scripts/fused_memory_torch.py [--config configs/models/naive.yaml] [--ks 1 2 4]

It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

GIB = 2**30


def segments() -> dict:
    """{"pool" | "default": [segments, reserved bytes, allocated bytes]}."""
    out: dict = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        key = "pool" if tuple(seg["segment_pool_id"]) != (0, 0) else "default"
        d = out.setdefault(key, [0, 0, 0])
        d[0] += 1
        d[1] += seg["total_size"]
        d[2] += seg["allocated_size"]
    return out


def report(tag: str) -> None:
    torch.cuda.synchronize()
    parts = "; ".join(f"{k}: {n} segments, reserved {r / GIB:.2f}, allocated {a / GIB:.2f}"
                      for k, (n, r, a) in sorted(segments().items()))
    print(f"{tag}: reserved {torch.cuda.memory_reserved() / GIB:.2f} GiB, allocated"
          f" {torch.cuda.memory_allocated() / GIB:.2f} GiB; {parts}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/models/naive.yaml")
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_memory_torch: no CUDA device")

    import main_torch
    from diffmst_torch.train import Batch
    from diffmst_torch.train.fused import FusedSteps
    from diffmst_torch.utils.config import load_config
    from diffmst_torch.utils.device import use_full_float32

    use_full_float32()
    torch.backends.cudnn.deterministic = True
    configs = ["configs/config.yaml", "configs/optimizer.yaml", args.config]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.chdir(ROOT):
        system, _, _ = main_torch.build_from_config(load_config([os.path.join(ROOT, c) for c in configs]))
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; {args.config}", flush=True)
    gen = torch.Generator().manual_seed(0)
    ids = torch.zeros(4, 8, dtype=torch.int32)
    batches = [Batch((10.0 ** (-48.0 / 20.0) * torch.randn(4, 8, 262144, generator=gen)).cuda(), ids, ids,
                     torch.zeros(4, 8, dtype=torch.bool, device="cuda"), torch.zeros(4, 2, 262144, device="cuda"))
               for _ in range(max(args.ks))]
    flags = system.effect_flags(0)
    torch.cuda.reset_peak_memory_stats()
    system.train_step(batches[0], flags)
    report(f"one eager step (peak allocated {torch.cuda.max_memory_allocated() / GIB:.2f} GiB)")
    for k in args.ks:
        torch.cuda.empty_cache()
        steps = FusedSteps(system, flags, k)
        torch.cuda.reset_peak_memory_stats()
        steps(batches[:k])
        report(f"K={k} after the warm-up group and the capture (pool_bytes {steps.pool_bytes / GIB:.2f} GiB,"
               f" capture {steps.capture_s:.3f} s, peak allocated {torch.cuda.max_memory_allocated() / GIB:.2f} GiB)")
        steps(batches[:k])
        report(f"K={k} after a replay")
        steps.release()
        del steps
        report(f"K={k} after release()")
    return 0


if __name__ == "__main__":
    sys.exit(main())
