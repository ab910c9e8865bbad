"""Tracing and step timing.

Counterpart of ``multimodalpromptretrieval_tpu/train/profiling.py``:

    with trace("logs/trace"):          # torch.profiler, a Chrome trace
        step(...)

    timer = StepTimer()
    with timer.step():                 # host wall clock per step
        ...
    timer.summary()                    # {steps, mean_s, p50_s, p90_s,
                                       #  steps_per_sec}

``trace`` records the host's activity, and the card's where CUDA is
available; ``annotate`` names a region in that trace. A step timed on the
card's work needs a ``torch.cuda.synchronize()`` inside the step: the host
returns before the device finishes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler.profile`` scope that writes
    ``{log_dir}/trace.json`` (Chrome trace format) when it closes: the
    host's activity, and the card's where CUDA is available."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Host-side per-step wall-clock accumulator."""

    def __init__(self, max_keep: int = 10000):
        self.durations: List[float] = []
        self.max_keep = max_keep

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations.append(time.perf_counter() - t0)
            if len(self.durations) > self.max_keep:
                del self.durations[: -self.max_keep]

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        d = sorted(self.durations[skip_first:] or self.durations)
        if not d:
            return {}
        n = len(d)
        mean = sum(d) / n
        return {
            "steps": n,
            "mean_s": mean,
            "p50_s": d[n // 2],
            "p90_s": d[min(n - 1, int(0.9 * n))],
            "steps_per_sec": (1.0 / mean) if mean > 0 else float("inf"),
        }
