"""The traced slice: device busy time, the idle gaps and what the host was
doing in them, and the device time of the kernels each benchmark span
launched.

``busy_seconds`` and the profiler set-up are a frozen copy of
``multimodalpromptretrieval_tpu_torch/profile_serve.py``
(``device_profile`` / ``_busy_seconds``): the union of the device's kernel
and copy intervals. The profiler stretches the window it traces, so the
idle share read here overstates the unprofiled one.

Attribution goes by the profiler's correlation of each kernel with the
host operation that launched it, never by kernel names: a benchmark span
(``record_function("pb. ...")``) owns the kernels launched inside it, on
the thread that opened it.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Tuple

import torch


def busy_seconds(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals, in seconds (us in)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def profile(fn: Callable[[], object]):
    """(profiler, host seconds) of ``fn()`` traced on the host (every
    thread, where this torch can) and the device."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    try:
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None
    kw = {"experimental_config": config} if config is not None else {}
    with torch.profiler.profile(activities=activities, **kw) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return prof, wall


def _is_device(ev) -> bool:
    """A kernel or copy on the card (the profiler's device-side mirrors of
    host annotations are not)."""
    return (ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("pb."))


def _subtree_kernels_us(ev) -> Tuple[float, int]:
    total, n, stack = 0.0, 0, [ev]
    while stack:
        e = stack.pop()
        for k in getattr(e, "kernels", ()) or ():
            total += float(k.duration)
            n += 1
        stack.extend(e.cpu_children)
    return total, n


def analyze(prof, wall: float) -> dict:
    """busy_s, window_s, the device operations by time, the idle gaps by
    the benchmark span open on the host, and each benchmark span's device
    seconds (the kernels it launched) and call count."""
    events = list(prof.events())
    device = [e for e in events if _is_device(e)]
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    spans = [e for e in events
             if e.device_type != torch.autograd.DeviceType.CUDA
             and e.name.startswith("pb.")]
    span_device: Dict[str, dict] = {}
    for e in spans:
        us, n = _subtree_kernels_us(e)
        rec = span_device.setdefault(e.name, {"device_s": 0.0, "calls": 0,
                                              "kernels": 0})
        rec["device_s"] += us * 1e-6
        rec["calls"] += 1
        rec["kernels"] += n

    # idle gaps between busy intervals, labelled by the shortest benchmark
    # span open at the gap's middle
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in spans)
    idle: Dict[str, float] = collections.defaultdict(float)
    active: List[tuple] = []
    i = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        while i < len(starts) and starts[i][0] <= mid:
            active.append(starts[i])
            i += 1
        active = [r for r in active if r[1] >= mid]
        label = (min(active, key=lambda r: r[1] - r[0])[2] if active
                 else "no benchmark span")
        idle[label] += (b - a) * 1e-6
    return {
        "busy_s": busy_seconds(intervals),
        "window_s": wall,
        "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:10],
        "spans": span_device,
    }
