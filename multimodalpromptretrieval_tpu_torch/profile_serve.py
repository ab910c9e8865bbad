"""Where the time goes in the north-star serving window, on one CUDA card.

    python3 -m multimodalpromptretrieval_tpu_torch.profile_serve \\
        [--path main|pallas] [--seed 0] [--repeats 3] [--out FILE.json]

The window is the one ``chip_smoke.py`` times: stage the 512 test images
through the ViT, then 1,536 questions in two submits (3 fused chunks of
B=512) on ``serving.north_star_setup`` (t5-small + ViT-B/32, bf16, k=1,
seeded random weights), with the attention knobs of
``serving.SERVE_PATHS[path]``: ``main`` (row towers and encoder, the
indicator decode on K7) or ``pallas`` (flash attention K8, the K6 decode).
After one warm-up window it measures:

1. ``repeats`` plain windows: seconds and QA/s each.
2. One window with the program's spans on (``train/profiling``): per
   span name its calls, total and self ms (the server's prepare, queue
   wait, chunk, run, fetch and consume; the tokenizers; the towers, the
   encoder, the decode, its steps and their EOS syncs) and the counters.
   Nothing is synced for them, so the caller's tokenizing overlaps the
   dispatcher's chunks as it does unmeasured; a span's self ms leaves out
   the spans inside it on its thread.
3. One window under ``torch.profiler``: device busy time (the union of
   kernel and copy intervals), idle share of the window's wall time, and
   device time by kernel group and by kernel name (every kernel in the
   JSON, the top 12 printed). The profiler stretches
   the window, so this idle share overstates the unprofiled one.

Prints a summary and, with ``--out``, writes every number as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch import serve
from multimodalpromptretrieval_tpu_torch.serving import (
    SERVE_PATHS,
    north_star_setup,
)
from multimodalpromptretrieval_tpu_torch.train import profiling

# kernel group -> substrings of the device kernel names it holds (K6 and K7
# are the two instantiations of one template; K1 and K8 each have a kernel
# per dtype and row length)
_GROUPS = (
    ("K1 row_attention", ("row_attention_",)),
    ("K2 layer_norm", ("_layer_norm_kernel",)),
    ("K3 rms_norm", ("_rms_norm_kernel",)),
    ("K4 l2_topk", ("tile_dist_kernel", "select_topk_kernel")),
    ("K6 decode_attention", ("decode_attention_kernel<float, false>",
                             "decode_attention_kernel<__nv_bfloat16, false>")),
    ("K7 decode_attention_fused",
     ("decode_attention_kernel<float, true>",
      "decode_attention_kernel<__nv_bfloat16, true>")),
    ("K8 flash_attention", ("flash_attention_",)),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("memcpy", ("memcpy",)),
    ("memset", ("memset",)),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other (elementwise, copy, reduce)"


def _window_fn(server: serve.MPRServer, tests: List[dict],
               images: Dict[str, np.ndarray]) -> Callable[[], List[str]]:
    names = [e["image_name"] for e in tests]
    unique = list(dict.fromkeys(names))
    questions = [e["question"] for e in tests]
    tasks = [e["task"] for e in tests]
    staged = np.stack([images[n] for n in unique])
    split = 2 * server.exp.batch_size

    def window() -> List[str]:
        server.stage_images(staged, unique)
        first = server.submit(None, questions[:split], tasks[:split],
                              image_ids=names[:split])
        second = server.submit(None, questions[split:], tasks[split:],
                               image_ids=names[split:])
        answers = first.result() + second.result()
        torch.cuda.synchronize()
        return answers

    return window


def _busy_seconds(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals, in seconds (us in)."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def device_profile(window: Callable[[], object]) -> dict:
    """One ``window()`` under ``torch.profiler``: its wall time, the device
    busy time (the union of kernel and copy intervals), the idle share, and
    device time and launches by kernel group and by kernel name."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        window()
        prof_wall = time.perf_counter() - t0
    intervals, by_group, by_name = [], defaultdict(float), defaultdict(float)
    count_group, count_name = defaultdict(int), defaultdict(int)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        intervals.append((s, e))
        g = _group(ev.name)
        by_group[g] += (e - s) * 1e-3
        count_group[g] += 1
        by_name[ev.name] += (e - s) * 1e-3
        count_name[ev.name] += 1
    busy = _busy_seconds(intervals)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "profiled_window_ms": prof_wall * 1e3,
        "device_busy_ms": busy * 1e3,
        "idle_share_profiled": 1.0 - busy / prof_wall,
        "device_events": len(intervals),
        "device_ms_by_group": dict(by_group),
        "device_launches_by_group": dict(count_group),
        "kernels_by_time": [{"name": k[:160], "ms": v,
                             "launches": count_name[k]} for k, v in ranked],
    }


def print_device_profile(res: dict) -> None:
    print(f"profiled window {res['profiled_window_ms']:.1f} ms, device busy "
          f"{res['device_busy_ms']:.1f} ms, idle share "
          f"{res['idle_share_profiled']:.3f}, {res['device_events']} device "
          "events")
    for k, v in sorted(res["device_ms_by_group"].items(),
                       key=lambda kv: -kv[1]):
        print(f"  {k:34s} {v:9.2f} ms  "
              f"{res['device_launches_by_group'][k]:6d} launches")
    print("top kernels:")
    for t in res["kernels_by_time"][:12]:
        print(f"  {t['ms']:9.2f} ms {t['launches']:6d}x  {t['name'][:120]}")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile(seed: int, repeats: int, path: str = "main") -> dict:
    exp, tests, images = north_star_setup(seed, path=path)
    server = serve.MPRServer(exp, load_checkpoint=False)
    window = _window_fn(server, tests, images)
    n = len(tests)
    window()  # warm-up: allocator, cuBLAS heuristics, Triton, every width

    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        window()
        runs.append(time.perf_counter() - t0)

    server.decode_steps = 0
    profiling.reset()
    profiling.enable()
    try:
        t0 = time.perf_counter()
        window()
        spans_window = time.perf_counter() - t0
    finally:
        profiling.enable(False)
    snap = profiling.snapshot(last=0)
    profiling.reset()
    decode_steps = server.decode_steps
    spans_ms = {k: {"calls": v["calls"], "total_ms": v["total_s"] * 1e3,
                    "self_ms": v["self_s"] * 1e3}
                for k, v in snap["spans"].items()}

    return {
        "device": torch.cuda.get_device_name(0),
        "path": path,
        "window": f"stage {len(set(e['image_name'] for e in tests))} images"
                  f" + {n} questions in 2 submits",
        "plain_windows_s": runs,
        "plain_qa_per_s": [n / s for s in runs],
        "spans_window_ms": spans_window * 1e3,
        "spans_ms": spans_ms,
        "counters": snap["counters"],
        "decode_steps_per_window": decode_steps,
        **device_profile(window),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--path", default="main", choices=sorted(SERVE_PATHS),
                        help="the serving path's attention knobs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", default=None,
                        help="write the numbers as JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    res = profile(args.seed, args.repeats, args.path)
    res["card"] = card
    print(card)
    print(f"path {args.path}: {SERVE_PATHS[args.path]}")
    print("plain windows: " + ", ".join(
        f"{q:.1f} QA/s ({s:.4f} s)"
        for q, s in zip(res["plain_qa_per_s"], res["plain_windows_s"])))
    total = res["spans_window_ms"]
    print(f"window with the program's spans {total:.2f} ms "
          "(total / self ms, calls):")
    for k, v in sorted(res["spans_ms"].items(),
                       key=lambda kv: -kv[1]["total_ms"]):
        print(f"  {k:26s} {v['total_ms']:9.2f} {v['self_ms']:9.2f} ms "
              f"{v['calls']:6d}x")
    print("counters: " + json.dumps(res["counters"]))
    print_device_profile(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
