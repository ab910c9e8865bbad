"""Tracing, spans, counters and step timing.

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

The program's own spans and counters, off by default:

    enable()                           # for the process; enable(False)
    with span("mpr.serve.chunk", request_id=3, chunk=0):
        ...                            # children inherit the attributes
    record("mpr.serve.queue_wait", start_ns, now_ns())  # begun elsewhere
    count("t5.decode_steps")           # an int, or a 0-d device tensor
    snapshot()                         # {"spans": name -> {calls, total_s,
                                       #  self_s}, "counters", "ring"}
    reset()

Off, ``span`` reads one module flag and returns one shared no-op context;
``count``, ``record`` and ``now_ns`` read the flag and return. On, a span
opens ``torch.profiler.record_function(name)``, so that under a running
profiler it is an event on the profiler's timeline and owns the kernels
launched inside it, and records its name, thread, parent (the span open
below it on its thread), attributes and ``time.perf_counter_ns()`` start
and end. Each thread writes buffers of its own, with no lock; ``snapshot``
merges them. A span's self seconds are its duration less the spans opened
inside it on its thread. The last ``RING`` spans of each thread stay in
memory as raw records; nothing is written but by ``trace`` (the
profiler's Chrome trace, which carries the spans as ``record_function``
events) and by the caller of ``snapshot``. Take ``snapshot`` and ``reset``
between windows, not while spans are being recorded.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List

import torch

RING = 4096  # raw spans kept a thread

_ON = False
_ids = itertools.count(1)
_local = threading.local()
_buffers: List["_Buffer"] = []
_buffers_lock = threading.Lock()  # taken once a thread, at its first span


def enable(on: bool = True) -> None:
    """Turn the program's spans and counters on (or off) for the process."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    return _ON


class _Noop:
    """The context ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Buffer:
    """One thread's totals (name -> (calls, total ns, self ns)), counters,
    open spans and last raw spans; only its own thread writes them."""

    def __init__(self):
        self.thread = threading.current_thread()
        self.tid = threading.get_native_id()
        self.stack: List["_Span"] = []
        self.totals: Dict[str, tuple] = {}
        self.counters: Dict[str, int] = {}
        self.ring: collections.deque = collections.deque(maxlen=RING)


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _buffers_lock:
            _buffers.append(buf)
    return buf


def _add(buf: _Buffer, name: str, dur: int, own: int) -> None:
    calls, total, self_ns = buf.totals.get(name, (0, 0, 0))
    buf.totals[name] = (calls + 1, total + dur, self_ns + own)


class _Span:
    __slots__ = ("name", "attrs", "id", "buf", "parent", "rf", "start",
                 "child_ns")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        buf = self.buf = _buffer()
        parent = self.parent = buf.stack[-1] if buf.stack else None
        if parent is not None and parent.attrs:
            self.attrs = {**parent.attrs, **self.attrs}
        self.id = next(_ids)
        self.child_ns = 0
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        buf.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        buf = self.buf
        buf.stack.pop()
        self.rf.__exit__(*exc)
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        _add(buf, self.name, dur, dur - self.child_ns)
        buf.ring.append({"id": self.id, "name": self.name,
                         "thread": buf.tid,
                         "parent": None if parent is None else parent.id,
                         "start_ns": self.start, "end_ns": end,
                         "attrs": self.attrs})
        return False


def span(name: str, **attrs):
    """A context that records ``name`` with ``attrs`` (request id, chunk
    index) while tracing is on; the shared no-op while it is off."""
    if not _ON:
        return _NOOP
    return _Span(name, attrs)


def now_ns() -> int:
    """``time.perf_counter_ns()`` while tracing is on, else 0: the start
    to give :func:`record` later."""
    return time.perf_counter_ns() if _ON else 0


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a span that began on another thread (``start_ns`` from
    :func:`now_ns` there) and ends on this one. A start of 0, taken while
    tracing was off, records nothing."""
    if not _ON or start_ns <= 0:
        return
    buf = _buffer()
    dur = end_ns - start_ns
    _add(buf, name, dur, dur)
    buf.ring.append({"id": next(_ids), "name": name, "thread": buf.tid,
                     "parent": None, "start_ns": start_ns, "end_ns": end_ns,
                     "attrs": attrs})


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on. ``n`` may be
    a 0-d tensor on the device: it is summed there and read (one sync) only
    by :func:`snapshot`, so a count that lives on the device costs the host
    no wait."""
    if not _ON:
        return
    counters = _buffer().counters
    counters[name] = counters.get(name, 0) + n


def snapshot(last: int = RING) -> dict:
    """Every thread's spans and counters merged: ``spans`` (name ->
    calls, total_s, self_s), ``counters`` (name -> count) and ``ring``,
    the last ``last`` raw spans in order of their start."""
    with _buffers_lock:
        bufs = list(_buffers)
    spans: Dict[str, dict] = {}
    counters: Dict[str, int] = {}
    ring: List[dict] = []
    for buf in bufs:
        for name, (calls, total, self_ns) in list(buf.totals.items()):
            s = spans.setdefault(name, {"calls": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            s["calls"] += calls
            s["total_s"] += total * 1e-9
            s["self_s"] += self_ns * 1e-9
        for name, n in list(buf.counters.items()):
            if isinstance(n, torch.Tensor):
                if n.is_cuda:  # summed on another thread's stream
                    torch.cuda.synchronize(n.device)
                n = int(n)
            counters[name] = counters.get(name, 0) + n
        ring.extend(list(buf.ring))
    ring.sort(key=lambda r: r["start_ns"])
    return {"spans": spans, "counters": counters,
            "ring": ring[-last:] if last > 0 else []}


def reset() -> None:
    """Clear every thread's totals, counters and raw spans; forget the
    buffers of threads that have ended."""
    with _buffers_lock:
        _buffers[:] = [b for b in _buffers if b.thread.is_alive()]
        for buf in _buffers:
            buf.totals.clear()
            buf.counters.clear()
            buf.ring.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler.profile`` scope that writes
    ``{log_dir}/trace.json`` (Chrome trace format) when it closes: the
    host's activity on every thread (where this torch can), the program's
    spans while they are on, and the card's activity where CUDA is
    available."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        kw = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        kw = {}
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts, **kw) as prof:
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
