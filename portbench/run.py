"""The benchmark of ``multimodalpromptretrieval_tpu_torch`` on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It builds the cell named in ``BENCHMARK.json``
from its files (``portbench/registry.py``), sets it up (weights from the
seed on the card, the program's experiment and server, every shape warmed),
runs the window, checks what the window produced against the plain
reference (``portbench/reference``), and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` and
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1`` runs the
window with the benchmark's spans on (the per-layer host and CUDA-event
timings, and the operations the answered questions need, for the MFU), then
traces a short slice of the same traffic under ``torch.profiler`` (the idle
share, the kernels' roofline shares, ``breakdown``), and reports the cell's
per-layer metrics.

It measures the port and nothing else: a run fails when, once the window
has closed, a module whose top-level name is ``jax``, ``jaxlib``, ``flax``
or ``multimodalpromptretrieval_tpu`` is loaded. Build and kernel caches
stay inside the checkout (the port's ``_build/``, Triton's cache under
``portbench/_cache/``).
"""

import time

_T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE = os.path.join(_HERE, "_cache")
# fixed directories inside the checkout, before anything loads Triton
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TRITON_HOME"] = _CACHE
os.environ["USE_FLAX"] = "0"

BANNED = ("jax", "jaxlib", "flax", "multimodalpromptretrieval_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def run_cell(registry, name: str, seed: int, seconds: float, trace: bool,
             device, quantize=None, control=False,
             t0: float = _T0) -> dict:
    """One run of a cell on ``device``; the result's fields, with
    ``checks`` last, and the readings behind them under ``"_ctx"``.
    ``control``: the check's control in the program's place; its numbers
    are the ones judged, and the program's go under the readings'
    ``"program"``."""
    import torch

    from portbench import peaks, profiling, rooflines

    cell = registry.cell(name)
    workload, config = cell["workload"], cell["config_file"]
    cuda = device.type == "cuda"
    driver = registry.driver(workload["driver"])(
        config, workload, seed, device, quantize=quantize)
    driver.setup()
    setup_s = time.perf_counter() - t0

    ctx = {"setup_s": setup_s, "config": config, "workload": workload,
           "cuda": cuda, "setup_parts": driver.setup_parts}
    spans = driver.spans(cuda) if trace else None
    stats = driver.run(seconds=seconds)
    ctx["stats"] = stats
    if trace:
        if cuda:
            torch.cuda.synchronize(device)
        ctx["spans"] = spans.totals()
        ctx["flops"] = driver.flops(stats)
        ctx["chunks"] = driver.chunks(stats)
        if cuda:
            spans.kernel_spans()
            slice_stats = {}
            prof, wall = profiling.profile(lambda: slice_stats.update(
                driver.run(units=workload["profile_units"])))
            spans.end_kernel_spans()
            ctx["profile_stats"] = slice_stats
            ctx["profile"] = profiling.analyze(prof, wall)
            ctx["kernels"] = rooflines.shares(
                config, getattr(spans, "kernel_calls", []),
                ctx["profile"]["spans"])
            del prof
        spans.restore()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_check = time.perf_counter()
    numbers, readings = driver.check(control=control)
    if control:
        readings["program"] = numbers
        numbers = readings.pop("control")
    ctx["readings"] = readings
    ctx["check_s"] = time.perf_counter() - t_check
    limits = workload["check"]["limits"]
    # the control reads only the numbers of the reference's own outputs
    judged = [k for k in limits if k in numbers] if control else limits
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in judged}
    correct = (stats["attempted"] > 0 and stats["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics(kind, name):
        value = registry.reader(m["name"], kind)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if cuda:
        card, limit = peaks.card()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": memory_peak}
    else:
        card, limit = "cpu", "none"
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": memory_peak}
    out = {"correct": bool(correct), "attempted": int(stats["attempted"]),
           "failed": int(stats["failed"]), "metrics": metrics, "device": dev}
    if trace and "profile" in ctx:
        p = ctx["profile"]
        dev["busy_s"], dev["window_s"] = p["busy_s"], p["window_s"]
        out["breakdown"] = {"device_ops": p["device_ops"],
                            "idle_gaps": p["idle_gaps"]}
        out["notes"] = {"card": card, "power_limit": limit,
                        "bounds": {k: v["bound"] for k, v in
                                   ctx.get("kernels", {}).items()}}
    out["checks"] = checks
    out["_ctx"] = ctx
    return out


def unit_profile(ends, parts: int = 5) -> list:
    """Seconds a unit (a pass or a step) in each of ``parts`` equal runs of
    the window's units, from their end times: a trend within the window."""
    import numpy as np

    d = np.diff(np.concatenate([[0.0], np.asarray(ends, dtype=float)]))
    return [float(c.mean()) for c in np.array_split(d, min(parts, len(d)))
            if len(c)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--quantize", default=None,
                        choices=("int8_all",),
                        help="serve with the program's int8 path (the "
                             "control of the check; never in a benchmark "
                             "run)")
    parser.add_argument("--control", action="store_true",
                        help="judge the check's control, the reference "
                             "with fp8 products, in the program's place: "
                             "the run reads as not correct where it fails "
                             "a limit (never in a benchmark run)")
    args = parser.parse_args(argv)

    import torch

    from portbench.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(registry, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0),
                   quantize=args.quantize, control=args.control)
    return emit(out)


def emit(out: dict, stdout=None, stderr=None) -> int:
    """Check the loaded modules, then print the run's readings, its checks
    last on standard error, and the result line last on standard output;
    0, or 3 (and no result) where a banned module is loaded."""
    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    ctx = out.pop("_ctx")
    found = banned_modules()
    if found:
        print("portbench: loaded modules outside the port: "
              + ", ".join(found), file=stderr)
        return 3
    stats = ctx["stats"]
    print(f"window: {stats['units']:.0f} units, {stats['answered']:.0f} "
          f"answered, {stats['seconds']:.3f} s; set-up {ctx['setup_s']:.3f} s;"
          f" check {ctx['check_s']:.3f} s",
          file=stderr)
    print("set-up parts: " + json.dumps(ctx["setup_parts"]), file=stderr)
    if stats.get("unit_ends"):
        print("seconds a unit, by fifths of the window: "
              + json.dumps(unit_profile(stats["unit_ends"])), file=stderr)
    if "spans" in ctx:
        print("spans: " + json.dumps(ctx["spans"]), file=stderr)
    if "kernels" in ctx:
        print("kernels: " + json.dumps(ctx["kernels"]), file=stderr)
    print("readings: " + json.dumps(ctx["readings"]), file=stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=stderr)
    print(json.dumps(out), file=stdout)
    stdout.flush()
    return 0

if __name__ == "__main__":
    sys.exit(main())
