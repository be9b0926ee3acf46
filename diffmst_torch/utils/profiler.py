"""Profiling and throughput instruments.

Port of ``diffmst_tpu/utils/profiler.py``:

  * ``trace`` — a context manager around ``torch.profiler.profile`` (CPU and,
    on a card, CUDA activities) that writes a Chrome trace into ``log_dir``;
    ``utils/trace_ops.py`` reads it, and the Trainer's ``profile_steps`` use
    it.
  * ``Meter`` — steps/s and audio-realtime-factor meter with warmup skipping
    and percentile summaries (plain Python, JAX's as it is).
  * ``device_timer`` — seconds per iteration of ``iters`` dependent calls of
    a function: on the card bracketed by CUDA events after one warm loop,
    the best of ``reps``; on the CPU by ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List

import torch
from torch.utils._pytree import tree_leaves, tree_map

__all__ = ["trace", "Meter", "device_timer"]


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Profile the block, the card's activity too where there is a card;
    when it ends, synchronize and write ``<log_dir>/trace_<pid>_<n>.json``
    (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class Meter:
    """Rolling steps/sec + realtime-factor meter."""

    def __init__(self, audio_seconds_per_step: float, warmup: int = 2,
                 window: int = 100) -> None:
        self.audio_seconds_per_step = audio_seconds_per_step
        self.warmup = warmup
        self.window = window
        self._times: List[float] = []
        self._last = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._last is not None and self._count > self.warmup:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        median = ts[len(ts) // 2]
        return {
            "steps_per_sec": 1.0 / median,
            "realtime_factor": self.audio_seconds_per_step / median,
            "p50_ms": median * 1e3,
            "p90_ms": ts[int(len(ts) * 0.9)] * 1e3,
        }


def device_timer(fn: Callable, example, iters: int = 20, reps: int = 5) -> float:
    """Seconds per iteration of ``fn`` over ``iters`` dependent calls.

    ``fn`` maps its argument (a tensor, or a tuple, list or dict of them) to
    one of the same structure; each output, scaled by 0.999, is the next
    call's input, as JAX's ``fori_loop`` carries it. Where ``example`` lies
    on a CUDA device the loop is bracketed by CUDA events after one warm
    loop (the host's launches are included where they outrun the card);
    elsewhere by ``time.perf_counter``. The best of ``reps`` loops.
    """
    def loop():
        a = example
        for _ in range(iters):
            a = tree_map(lambda t: t * 0.999, fn(a))
        return a

    cuda = tree_leaves(example)[0].device.type == "cuda"
    with torch.no_grad():
        loop()
        if cuda:
            torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loop()
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                loop()
                seconds = time.perf_counter() - t0
            best = min(best, seconds / iters)
    return best
