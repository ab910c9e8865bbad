"""Where the time goes in the full-width train step, on one CUDA card.

    python3 -m multimodalpromptretrieval_tpu_torch.profile_train \\
        [--seed 0] [--steps 10] [--out FILE.json]

The step is the one ``chip_smoke.py`` times
(``train.experiment.north_star_train_setup``: t5-small + ViT-B/32, row
attention, fp32 masters with bf16 compute, B=128, 32 prompt tokens behind
the 50-token prefix, 8 label tokens, dropout 0.1, seeded random weights),
on one fixed batch from the cached vision tokens. After 3 warm-up steps it
measures:

1. ``steps`` plain steps, one device sync at the end: ms per step and
   examples per second.
2. ``steps`` steps with a device sync around each stage: the forward
   (refresh of the bf16 compute copy + ``loss_fn``), the backward
   (``train.step.backward``) and the optimizer (``adamw_update``), ms per
   step each; what is left is host work between the stages.
3. 3 steps under ``torch.profiler``: device busy time, idle share, and
   device time by kernel group and by kernel name. The profiler stretches
   the window, so this idle share overstates the unprofiled one.

Prints a summary and, with ``--out``, writes every number as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import defaultdict
from typing import Dict

import torch

from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.profile_serve import (
    card_name,
    device_profile,
    print_device_profile,
)
from multimodalpromptretrieval_tpu_torch.train import step as steps
from multimodalpromptretrieval_tpu_torch.train.experiment import (
    north_star_train_setup,
)

# (module, attribute, stage name) of the three stages of a step
_STAGES = ((mprgen, "loss_fn", "forward"),
           (steps, "backward", "backward"),
           (steps, "adamw_update", "optimizer"))


@contextlib.contextmanager
def _timed(targets, acc: Dict[str, float], sync: bool):
    """Replace each (owner, attribute) with a wrapper that adds its
    seconds to ``acc[stage]``; with ``sync`` it waits for the device
    before and after, so the time is the stage's own (a train step is
    serial: nothing overlaps it)."""
    saved = []
    for owner, attr, stage in targets:
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _stage=stage, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[_stage] += time.perf_counter() - t0
            return out

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def profile(seed: int, n_steps: int) -> dict:
    exp = north_star_train_setup(seed, quiet=True)
    exp.retrieval_index.is_training_phase = True
    exp.precompute_hints("train")
    exp.build_vision_token_cache("train", "validate")
    batch = exp.device_batch(exp.make_split_batches(
        "train", shuffle=True, epoch=0)[0])
    step = exp.train_step()
    lr = exp.cfg["hyperparameters"]["learning_rate"]

    def run(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(exp.params, exp.opt_state, batch, lr, exp.dropout_gen)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(3)  # warm-up: allocator, cuBLAS heuristics, Triton
    plain_s = run(n_steps)
    acc: Dict[str, float] = defaultdict(float)
    with _timed(_STAGES, acc, sync=True):
        synced_s = run(n_steps)
    stages_ms = {k: v * 1e3 / n_steps for k, v in acc.items()}
    stages_ms["rest_of_host"] = (synced_s - sum(acc.values())) * 1e3 / n_steps
    B = exp.batch_size
    return {
        "device": torch.cuda.get_device_name(0),
        "step": f"B={B}, L=82, T=8, bf16 compute, dropout "
                f"{exp.model_cfg.t5.dropout_rate}",
        "plain_ms_per_step": plain_s * 1e3 / n_steps,
        "examples_per_s": B * n_steps / plain_s,
        "synced_ms_per_step": synced_s * 1e3 / n_steps,
        "stages_ms_per_step": stages_ms,
        "profiled_steps": 3,
        **device_profile(lambda: run(3)),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--out", default=None,
                        help="write the numbers as JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = profile(args.seed, args.steps)
    res["card"] = card_name()
    print(res["card"])
    print(f"{res['step']}: {res['plain_ms_per_step']:.2f} ms per step, "
          f"{res['examples_per_s']:.1f} examples/s over {args.steps} steps")
    total = res["synced_ms_per_step"]
    print(f"synced step {total:.2f} ms:")
    for k, v in sorted(res["stages_ms_per_step"].items(),
                       key=lambda kv: -kv[1]):
        print(f"  {k:14s} {v:9.2f} ms  {100 * v / total:5.1f}%")
    print_device_profile(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
