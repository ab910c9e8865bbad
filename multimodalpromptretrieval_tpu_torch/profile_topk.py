"""How L2 top-k (K4) splits its time between the dots and the selection.

    python3 -m multimodalpromptretrieval_tpu_torch.profile_topk \
        [--out profile_topk.json]

Times ``l2_topk`` at the serving shapes (512 queries of 1,024 fp32 against
N = 1,230 and N = 5,000 index rows) for k = 1, 2, 16 and 32, by
``torch.profiler`` device time per kernel name over 10 calls after 3
warm-ups: the distance kernel (the fp32 dots, ``tile_dist_kernel``) and the
selection kernel (``select_topk_kernel``) apart, with the rate of the dots
against the card's fp32 peak. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from multimodalpromptretrieval_tpu_torch.ops import topk

B, D = 512, 1024
SIZES = (1230, 5000)
KS = (1, 2, 16, 32)
KERNELS = ("tile_dist_kernel", "select_topk_kernel")


def device_ms(fn, iters: int = 10, warmup: int = 3) -> dict:
    """Mean device time per call of each of K4's kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {name: 0.0 for name in KERNELS}
    for e in prof.key_averages():
        for name in KERNELS:
            if name in e.key:
                ms[name] += e.device_time_total / iters / 1e3
    if min(ms.values()) <= 0:
        raise RuntimeError(f"the profiler recorded no time for {ms}")
    return ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_topk: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    query = torch.randn((B, D), generator=gen, device=dev)
    rows = []
    for N in SIZES:
        index = torch.randn((N, D), generator=gen, device=dev)
        sq = torch.sum(index * index, dim=-1)
        for k in KS:
            ms = device_ms(lambda: topk.l2_topk(query, index, k,
                                                index_sq=sq))
            dots, select = (ms[name] for name in KERNELS)
            row = dict(N=N, k=k, dots_ms=dots, select_ms=select,
                       dots_tflops=2.0 * B * N * D / dots / 1e9)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
