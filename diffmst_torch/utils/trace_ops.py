"""Op-level profiles from ``torch.profiler`` traces.

The counterpart of ``diffmst_tpu/utils/xplane.py``, which parses the XSpace
protobufs of ``jax.profiler``; the port reads the Chrome-trace JSON that
``torch.profiler`` exports (``utils/profiler.py::trace``, the Trainer's
``profile_steps``). A trace holds two planes:

  * the device ("cuda"): events whose ``cat`` is ``kernel``, ``gpu_memcpy``
    or ``gpu_memset``, one line per CUDA stream; they do not overlap on a
    stream, so their durations add up to the card's busy time;
  * the host ("cpu"): ``cpu_op`` events (PyTorch operators) and
    ``user_annotation`` events (``record_function`` ranges such as
    ``system.model``), one line per thread. Host events nest, so a range's
    duration includes the operators inside it.

Summing event durations per name gives per-op totals with JAX's keys.

    python -m diffmst_torch.utils.trace_ops <trace dir> [device_substr]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, List

__all__ = ["find_trace_files", "top_ops_from_trace", "category_breakdown_from_trace"]

# a plane's names, and the event categories on it
_PLANES = (
    (("cuda", "gpu", "device"), ("kernel", "gpu_memcpy", "gpu_memset")),
    (("cpu", "host"), ("cpu_op", "user_annotation")),
)


def find_trace_files(trace_dir: str) -> List[str]:
    """Every Chrome trace (``*.json``, ``*.json.gz``) under ``trace_dir``."""
    paths = []
    for pattern in ("*.json", "*.json.gz"):
        paths += glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)
    return sorted(paths)


def _load_events(path: str) -> List[Dict]:
    """The complete ("X") events of one trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def top_ops_from_trace(trace_dir: str, top_n: int = 15, device_substr: str = "cuda") -> List[Dict]:
    """Top-N ops by accumulated duration on the plane ``device_substr``
    names ("cuda", or "gpu"/"device", for the card's kernels, copies and
    memsets; "cpu" or "host" for the host's operators and ranges), over
    every trace file under ``trace_dir``.

    Returns dicts: rank, op, line (the CUDA stream or host thread), category
    (the event's ``cat``), occurrences, total_ms, pct_of_total, and the
    per-call gflops and gbytes where the trace records them (``flops`` of
    an operator traced ``with_flops``), else 0.
    """
    paths = find_trace_files(trace_dir)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    cats = {c for names, plane in _PLANES if device_substr.lower() in names for c in plane}
    # op name -> [total_us, occurrences, line, category, flops, bytes]
    agg: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0, "", "", 0, 0])
    seen = collections.Counter()
    for path in paths:
        for ev in _load_events(path):
            cat = ev.get("cat", "")
            seen[cat] += 1
            if cat not in cats:
                continue
            args = ev.get("args") or {}
            a = agg[ev.get("name", "")]
            a[0] += float(ev["dur"])
            a[1] += 1
            a[2] = f"stream {args['stream']}" if "stream" in args else f"thread {ev.get('tid', '')}"
            if not a[3]:
                a[3] = cat
                a[4] = int(args.get("flops", 0) or 0)
                a[5] = int(args.get("bytes", 0) or 0)
    if not agg:
        raise ValueError(f"no {device_substr!r} events found (categories seen: {dict(seen) or 'none'})")
    total_us = sum(a[0] for a in agg.values())
    rows = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=True)
    return [
        {
            "rank": i + 1,
            "op": name[:160],
            "line": a[2],
            "category": a[3],
            "occurrences": a[1],
            "total_ms": round(a[0] / 1e3, 3),
            "pct_of_total": round(100.0 * a[0] / total_us, 1) if total_us else 0.0,
            "gflops_per_call": round(a[4] / 1e9, 3),
            "gbytes_per_call": round(a[5] / 1e9, 4),
        }
        for i, (name, a) in enumerate(rows[:top_n])
    ]


def category_breakdown_from_trace(trace_dir: str, device_substr: str = "cuda") -> List[Dict]:
    """Time on the plane grouped by the events' ``cat`` (kernel, gpu_memcpy,
    gpu_memset; or cpu_op, user_annotation): the where-does-the-step-go
    view, with JAX's keys."""
    rows = top_ops_from_trace(trace_dir, top_n=10**6, device_substr=device_substr)
    agg: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0, 0.0])
    for r in rows:
        a = agg[r["category"] or "(uncategorized)"]
        a[0] += r["total_ms"]
        a[1] += r["occurrences"]
        a[2] += r["gflops_per_call"] * r["occurrences"]
    total_ms = sum(a[0] for a in agg.values())
    out = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=True)
    return [
        {
            "category": cat,
            "total_ms": round(a[0], 3),
            "pct_of_total": round(100.0 * a[0] / total_ms, 1) if total_ms else 0.0,
            "occurrences": a[1],
            "total_gflops": round(a[2], 1),
        }
        for cat, a in out
    ]


if __name__ == "__main__":
    import sys

    substr = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    print(json.dumps(top_ops_from_trace(sys.argv[1], device_substr=substr), indent=1))
