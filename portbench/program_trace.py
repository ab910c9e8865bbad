"""The program's own spans and counters in the traced run.

The port records spans (``mpr.`` names) and counters of its own
(``multimodalpromptretrieval_tpu_torch/train/profiling.py``), off unless
switched on. The traced run turns them on for its window, reads their
totals after it (:func:`snapshot`), clears them before the profiled
slice, and puts the slice's kernels and idle gaps down to them
(:func:`analyze`). A program without them (a checkout from before they
existed) gives nothing: :func:`snapshot` returns None, :func:`analyze`
finds no span, and the readers of these metrics return None.

Attribution goes by the profiler's link of each device operation (kernel,
copy, memset) to the runtime call that launched it, on the thread that
made the call, never by kernel names:

* a device operation belongs to every ``mpr.`` span open on the launching
  thread when the runtime call was made;
* an idle gap between two busy intervals of the card belongs to the
  innermost ``mpr.`` span open, at the gap's middle, on the thread that
  launched the operation that ends the gap. So the dispatcher's decode and
  the caller's tokenizing, both open while the card waits, are told apart
  by which of them the card was waiting for.

``run.run_cell`` does not call these yet: :class:`WithProgram` wraps a
registry so that a traced run of a cell reports :data:`METRICS` too,

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        --seconds <s> [--program 0]

(the result line of ``--trace 1`` with the six metrics; ``--program 0``
the same run with the program's spans left off, to price them).
"""

from __future__ import annotations

import argparse
import collections
import sys
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PREFIX = "mpr."
NONE = "no program span"


def program():
    """The program's span module, or None where it has no switch."""
    try:
        from multimodalpromptretrieval_tpu_torch.train import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("enable", "snapshot",
                                               "reset")):
        return None
    return profiling


def enable(on: bool = True) -> None:
    """Clear what the program recorded, then turn its spans on (or off)."""
    p = program()
    if p is not None:
        if on:
            p.reset()
        p.enable(on)


def snapshot() -> Optional[dict]:
    """The program's span totals and counters, without the raw spans."""
    p = program()
    if p is None:
        return None
    snap = p.snapshot(last=0)
    return {"spans": snap["spans"], "counters": snap["counters"]}


def reset() -> None:
    p = program()
    if p is not None:
        p.reset()


def _open_at(spans: List, queries: Iterable[Tuple[float, int]]
             ) -> Dict[int, tuple]:
    """For each (time, key), the spans of one thread open at that time,
    outermost first. The spans of a thread nest, so one sweep with a
    stack does it."""
    spans = sorted(spans, key=lambda e: e.time_range.start)
    out: Dict[int, tuple] = {}
    stack: List = []
    i = 0
    for t, key in sorted(queries):
        while i < len(spans) and spans[i].time_range.start <= t:
            s = spans[i]
            i += 1
            while stack and stack[-1].time_range.end < s.time_range.start:
                stack.pop()
            stack.append(s)
        while stack and stack[-1].time_range.end < t:
            stack.pop()
        out[key] = tuple(stack)
    return out


def analyze(prof, wall: float) -> dict:
    """The profiled slice's ``mpr.`` spans: ``spans`` (name -> calls, the
    device operations launched inside them, their device seconds),
    ``idle`` (name of the innermost span the card waited on -> idle
    seconds, between its first and last operation), ``window_s`` and
    ``unlinked`` (device operations whose launch the trace lacks)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    device, host = [], []
    for e in events:
        if e.device_type == cuda:
            if (not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith((PREFIX, "pb."))):
                device.append(e)
        else:
            host.append(e)
    spans_by_thread: Dict[int, List] = collections.defaultdict(list)
    spans: Dict[str, dict] = {}
    for e in host:
        if e.name.startswith(PREFIX):
            spans_by_thread[e.thread].append(e)
            rec = spans.setdefault(e.name, {"calls": 0, "kernels": 0,
                                            "device_s": 0.0})
            rec["calls"] += 1
    # the runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemcpyAsync, ...) that shares its correlation id with each
    # device operation
    launches = {e.id: e for e in host if e.name.startswith("cu")}

    device.sort(key=lambda e: e.time_range.start)
    queries: Dict[int, List[Tuple[float, int]]] = collections.defaultdict(
        list)
    linked = {}
    for k, e in enumerate(device):
        launch = launches.get(e.id)
        if launch is not None:
            linked[k] = launch.thread
            queries[launch.thread].append((launch.time_range.start, k))
    # the busy intervals, each with the operation that opens it
    merged: List[list] = []
    for k, e in enumerate(device):
        s, t = e.time_range.start, e.time_range.end
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t, k])
    gaps = []
    for (_, a, _), (b, _, k) in zip(merged, merged[1:]):
        if k in linked:
            key = -1 - len(gaps)
            queries[linked[k]].append((0.5 * (a + b), key))
        gaps.append((b - a, k))

    found: Dict[int, tuple] = {}
    for thread, qs in queries.items():
        found.update(_open_at(spans_by_thread.get(thread, []), qs))
    for k, e in enumerate(device):
        for name in {s.name for s in found.get(k, ())}:
            rec = spans[name]
            rec["kernels"] += 1
            rec["device_s"] += (e.time_range.end - e.time_range.start) * 1e-6
    idle: Dict[str, float] = collections.defaultdict(float)
    for g, (us, _) in enumerate(gaps):
        chain = found.get(-1 - g, ())
        idle[chain[-1].name if chain else NONE] += us * 1e-6
    return {"window_s": wall, "spans": spans,
            "idle": dict(sorted(idle.items(), key=lambda x: -x[1])),
            "unlinked": len(device) - len(linked)}


_SERVER, _T5, _DEVICE = ("server (serve.MPRServer)", "T5 (models/t5.py)",
                         "device (H100)")
# the per-layer metrics these spans feed, as a BENCHMARK.json entry gives
# them; each has a reader under layer_metrics/
METRICS = [
    {"name": "server.queue_wait_ms_per_chunk", "unit": "ms",
     "better": "lower", "source": "program_span", "layer": _SERVER},
    {"name": "server.dispatcher_busy_share", "unit": "%",
     "better": "higher", "source": "program_span", "layer": _SERVER},
    {"name": "t5.decode_launch_ms_per_step", "unit": "ms",
     "better": "lower", "source": "program_span", "layer": _T5},
    {"name": "t5.decode_sync_ms_per_step", "unit": "ms",
     "better": "lower", "source": "program_span", "layer": _T5},
    {"name": "t5.decode_kernels_per_step", "unit": "kernels",
     "better": "lower", "source": "device_trace", "layer": _T5},
    {"name": "device.idle_share.decode_launch", "unit": "%",
     "better": "lower", "source": "device_trace", "layer": _DEVICE},
]


class WithProgram:
    """A registry for ``run.run_cell(..., trace=True)`` under which the
    window runs with the program's spans on (:func:`snapshot` after it),
    the profiled slice with them cleared first and :func:`analyze` over
    it, and the per-layer metrics add :data:`METRICS`, read from
    ``ctx["program"]`` and ``ctx["program_profile"]``. ``program=False``:
    the same run with the spans off."""

    def __init__(self, registry, program: bool = True):
        self.registry = registry
        self.program = program
        self.found: dict = {}

    def __getattr__(self, name):
        return getattr(self.registry, name)

    def driver(self, name: str):
        base, found, on = self.registry.driver(name), self.found, self.program

        class Driver(base):
            def run(self, seconds=None, units=None):
                if seconds is None:  # set-up's warm-up, the profiled slice
                    reset()
                    return super().run(units=units)
                enable(on)
                stats = super().run(seconds=seconds)
                found["program"] = snapshot()
                return stats

        return Driver

    def metrics(self, kind: str, cell: str) -> List[dict]:
        extra = [dict(m, moves="serve_qa_per_s") for m in METRICS]
        return self.registry.metrics(kind, cell) + (
            extra if kind == "per_layer" else [])

    def reader(self, metric: str, kind: str = "per_layer"):
        read = self.registry.reader(metric, kind)
        return lambda ctx: read({**ctx, **self.found})

    def run_cell(self, name: str, seed: int, seconds: float, device,
                 **kw) -> dict:
        """``run.run_cell`` of a traced run, through this registry; the
        readings under ``out["_ctx"]`` add ``program`` and, on the card,
        ``program_profile``."""
        from portbench import profiling, run

        analyze_slice = profiling.analyze

        def both(prof, wall):
            self.found["program_profile"] = analyze(prof, wall)
            return analyze_slice(prof, wall)

        profiling.analyze = both
        try:
            out = run.run_cell(self, name, seed, seconds, True, device,
                               **kw)
        finally:
            profiling.analyze = analyze_slice
            enable(False)
        out["_ctx"].update(self.found)
        return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)

    from portbench import run
    from portbench.registry import Registry

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    out = WithProgram(Registry(), bool(args.program)).run_cell(
        args.workload, args.seed, args.seconds, torch.device("cuda", 0))
    return run.emit(out)


if __name__ == "__main__":
    sys.exit(main())
