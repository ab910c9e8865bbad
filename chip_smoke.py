#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. Builds the port's kernels from the sources in this checkout (nvcc for the
   CUDA C++ kernels, Triton for the norms) and prints the build time.
2. Compares each of the seven kernels with its plain PyTorch version on the
   card, in fp32 and bf16, at the serving paths' shapes; prints the error
   against the stated tolerance and the device time per call of both.
3. Drives two serving paths at full width (t5-small + CLIP ViT-B/32, bf16,
   chunk B=512, retrieval k=1, seeded random weights): a 1,230-entry
   retrieval corpus embedded by the port's CLIP, 512 staged images, 1,536
   questions sent as two submits, the second queued behind the first. The
   main path is the north-star config (row attention in the towers and the
   encoder, the default ``decode_attention_impl="indicator"``): K1-K4 and
   K7. The second, "pallas" path sets ``attention_impl="pallas"`` in both
   towers and the encoder and ``decode_attention_impl="pallas"``: K8, K6
   and K4 (``serving.SERVE_PATHS``). The kernels' launch counts are reset
   just before each path and read just after.
4. Checks each path's result: every request answered through the fused
   path, each of its kernels launched, finite staged tables, and the kernel
   path agreeing with the plain versions (CPU, fp32) on a small input.

Prints the card's name and power limit, one JSON line of per-kernel results
and, last, ``{"ok": true, "device": {...}}``. Exits non-zero, with no result
line, when there is no CUDA device, a kernel does not build or disagrees, or
any phase fails.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "row_attention_packed": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/row_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/row_attention.py:171"),
    "fused_layer_norm": dict(
        route="triton",
        source="multimodalpromptretrieval_tpu_torch/ops/_norm_triton.py",
        replaces="multimodalpromptretrieval_tpu/ops/norm.py:35"),
    "fused_rms_norm": dict(
        route="triton",
        source="multimodalpromptretrieval_tpu_torch/ops/_norm_triton.py",
        replaces="multimodalpromptretrieval_tpu/ops/norm.py:47"),
    "l2_topk": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/l2_topk.cu",
        replaces="multimodalpromptretrieval_tpu/ops/topk.py:53"),
    "decode_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/decode_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/decode_attention.py:190"),
    "decode_attention_fused": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/decode_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/decode_attention.py:312"),
    "flash_attention": dict(
        route="cuda",
        source="multimodalpromptretrieval_tpu_torch/csrc/flash_attention.cu",
        replaces="multimodalpromptretrieval_tpu/ops/attention.py:62"),
}
# each serving path's kernels (its config: serving.SERVE_PATHS); a kernel's
# "launches" come from the first path that runs it
PATH_KERNELS = {
    "main": ("row_attention_packed", "fused_layer_norm", "fused_rms_norm",
             "l2_topk", "decode_attention_fused"),
    "pallas": ("flash_attention", "decode_attention", "l2_topk"),
}


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time per call: CUDA events around ``iters`` calls that
    the host queues behind a sleep kernel, so that the device runs them back
    to back and the host's dispatch (tens of us per wrapper call, longer
    than a decode-step kernel runs) does not gap them. The sleep lasts about
    twice the host time of an unhidden run of the same calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles a second is about the H100's boost clock; a lower clock
    # only lengthens the sleep
    torch.cuda._sleep(int(2 * host_s * 2e9) + 2_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at the output's scale (its largest magnitude)."""
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


class Checks:
    def __init__(self):
        self.failures = []
        self.results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def expect(self, ok: bool, what: str) -> None:
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def compare(self, kernel, case, got, want, tol, fn=None, plain=None,
                headline=False):
        err = (got.float() - want.float()).abs().max().item()
        res = self.results[kernel]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        line = f"{kernel} {case}: max_abs_err={err:.3g} (tol {tol:.3g})"
        if fn is not None:
            ms, plain_ms = time_ms(fn), time_ms(plain)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if headline:
                res["ms"], res["plain_ms"] = ms, plain_ms
        self.expect(bool(err <= tol) and bool(torch.isfinite(got).all()),
                    line)


def input_makers(dev):
    """Seeded makers of the kernel phase's inputs on ``dev``: ``randn(*shape,
    dtype=)`` and ``key_mask(B, L)`` ((B, L) int32, each row's first L // 2
    to L keys valid)."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def key_mask(B, L):
        lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
        return (torch.arange(L, device=dev)[None, :]
                < lens[:, None]).to(torch.int32)

    return randn, key_mask


def check_kernels(checks: Checks, dev) -> None:
    randn, key_mask = input_makers(dev)
    check_row_attention(checks, randn, key_mask)
    check_norms(checks, randn)
    check_topk(checks, randn)
    check_decode_attention(checks, randn, key_mask)
    check_flash_attention(checks, randn, key_mask)


def check_row_attention(checks: Checks, randn, key_mask) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import row_attention

    print("K1 row attention (CUDA) vs row_attention_packed_reference:")
    cases = [  # name, B, L, W, H, scale, causal, bias+mask
        ("vit", 512, 50, 768, 12, 64 ** -0.5, False, False),
        ("text", 512, 16, 512, 8, 64 ** -0.5, True, False),
        ("t5_enc_L82", 512, 82, 512, 8, 1.0, False, True),
        ("t5_enc_L562", 128, 562, 512, 8, 1.0, False, True),
    ]
    for name, B, L, W, H, scale, causal, with_bias in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(B, L, 3 * W, dtype=dt)
            bias = mask = None
            if with_bias:
                bias = randn(H, L, L, dtype=dt)
                mask = key_mask(B, L)
            kw = dict(heads=H, scale=scale, causal=causal)
            kernel = row_attention.row_attention_packed
            reference = row_attention.row_attention_packed_reference
            fn = lambda: kernel(qkv, bias, mask, **kw)  # noqa: E731
            plain = lambda: reference(qkv, bias, mask, **kw)  # noqa: E731
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            checks.compare("row_attention_packed",
                           f"{name} {str(dt)[6:]} qkv{tuple(qkv.shape)}",
                           fn(), want, tol, fn, plain,
                           headline=(name == "vit" and dt == torch.bfloat16))


def check_norms(checks: Checks, randn) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import norm

    print("K2 / K3 norms (Triton) vs their plain versions:")
    for rows, W in ((512 * 50, 768), (512 * 82, 512)):
        for dt in (torch.float32, torch.bfloat16):
            x = (randn(rows, W) * 2 + 0.5).to(dt)
            w, b = randn(W, dtype=dt), randn(W, dtype=dt)
            for kernel, fn, plain in (
                    ("fused_layer_norm",
                     lambda: norm.fused_layer_norm(x, w, b),
                     lambda: norm.fused_layer_norm_reference(x, w, b)),
                    ("fused_rms_norm",
                     lambda: norm.fused_rms_norm(x, w),
                     lambda: norm.fused_rms_norm_reference(x, w))):
                want = plain()
                tol = 1e-5 if dt == torch.float32 else bf16_ulp(want)
                headline = dt == torch.bfloat16 and (
                    (kernel == "fused_layer_norm" and W == 768)
                    or (kernel == "fused_rms_norm" and W == 512))
                checks.compare(kernel, f"{str(dt)[6:]} x({rows}, {W})",
                               fn(), want, tol, fn, plain, headline)


def check_topk(checks: Checks, randn) -> None:
    from multimodalpromptretrieval_tpu_torch.ops import topk

    print("K4 L2 top-k (CUDA) vs l2_topk_reference:")
    query = randn(512, 1024)
    for N in (1230, 5000):
        index = randn(N, 1024)
        sq = torch.sum(index * index, dim=-1)
        for k in (1, 15):
            for skip in (False, True):
                fn = lambda: topk.l2_topk(  # noqa: E731
                    query, index, k, index_sq=sq, skip_first=skip)
                fetch = k + 1 if skip else k
                plain = lambda: topk.l2_topk_reference(  # noqa: E731
                    query, index, fetch, sq)
                d, i = fn()
                rd, ri = plain()
                if skip:
                    rd, ri = rd[:, 1:], ri[:, 1:]
                case = f"N={N} k={k} skip_first={skip}"
                checks.expect(bool(torch.equal(i, ri)),
                              f"l2_topk {case}: indices identical")
                checks.compare("l2_topk", case + " distances", d, rd, 1e-3,
                               fn, plain,
                               headline=(N == 1230 and k == 1 and not skip))


def check_decode_attention(checks: Checks, randn, key_mask) -> None:
    """K6 / K7 at the decode loop's shapes: self-attention reads q as a
    column slice of the (B, 3W) qkv rows with the (H, T) bias row;
    cross-attention reads the (B, 82, W) encoder caches with the key
    mask."""
    from multimodalpromptretrieval_tpu_torch.ops import decode_attention as da

    print("K6 / K7 decode attention (CUDA) vs decode_attention_reference / "
          "decode_attention_indicator_reference:")
    B, H, W = 512, 8, 512
    for case, T in (("self", 20), ("cross", 82)):
        for dt in (torch.float32, torch.bfloat16):
            k, v = randn(B, T, W, dtype=dt), randn(B, T, W, dtype=dt)
            if case == "self":
                q = randn(B, 3 * W, dtype=dt)[:, :W]
                bias, mask = randn(H, T), None
            else:
                q, bias, mask = randn(B, W, dtype=dt), None, key_mask(B, T)
            for name, plain_fn in (
                    ("decode_attention", da.decode_attention_reference),
                    ("decode_attention_fused",
                     da.decode_attention_indicator_reference)):
                kernel = getattr(da, name)
                fn = lambda: kernel(q, k, v, bias, mask, heads=H)  # noqa: E731
                plain = lambda: plain_fn(  # noqa: E731
                    q, k, v, bias, mask, heads=H)
                want = plain()
                tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
                checks.compare(
                    name, f"{case} {str(dt)[6:]} B={B} T={T} W={W}",
                    fn(), want, tol, fn, plain,
                    headline=(case == "cross" and dt == torch.bfloat16))


def check_flash_attention(checks: Checks, randn, key_mask) -> None:
    """K8 over the (B, H, L, 64) head views of packed QKV rows, as the
    towers and the encoder call it under attention_impl="pallas"."""
    from multimodalpromptretrieval_tpu_torch.ops import attention

    print("K8 flash attention (CUDA) vs flash_attention_reference:")
    cases = [  # name, B, H, L, scale, causal, bias + mask
        ("vit", 512, 12, 50, 64 ** -0.5, False, False),
        ("text", 512, 8, 16, 64 ** -0.5, True, False),
        ("t5_enc_L82", 512, 8, 82, 1.0, False, True),
        ("t5_enc_L562", 128, 8, 562, 1.0, False, True),
        ("causal_L4096", 1, 8, 4096, 64 ** -0.5, True, False),
    ]
    for name, B, H, L, scale, causal, with_bias in cases:
        for dt in (torch.float32, torch.bfloat16):
            qkv = randn(B, L, 3, H, 64, dtype=dt)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            bias = mask = None
            if with_bias:
                bias, mask = randn(1, H, L, L), key_mask(B, L)
            kw = dict(causal=causal, scale=scale)
            fn = lambda: attention.flash_attention(  # noqa: E731
                q, k, v, bias, mask, **kw)
            plain = lambda: attention.flash_attention_reference(  # noqa: E731
                q, k, v, bias, mask, **kw)
            want = plain()
            tol = 2e-5 if dt == torch.float32 else bf16_ulp(want)
            checks.compare("flash_attention",
                           f"{name} {str(dt)[6:]} q{tuple(q.shape)}", fn(),
                           want, tol, fn, plain,
                           headline=(name == "vit" and dt == torch.bfloat16))


def serving_setup(seed: int, dev, path: str, params=None):
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    t0 = time.time()
    exp, tests, images = north_star_setup(seed, dev, path=path,
                                          params=params)
    torch.cuda.synchronize()
    cfg = exp.model_cfg
    print(f"{path} path setup: data, {'shared' if params else 'random'} "
          f"weights and a {len(exp.retrieval_index)}-entry index in "
          f"{time.time() - t0:.1f} s; T5 attention_impl="
          f"{cfg.t5.attention_impl!r}, decode_attention_impl="
          f"{cfg.t5.decode_attention_impl!r}, CLIP attention_impl="
          f"{cfg.clip.attention_impl!r}", flush=True)
    return exp, tests, images


def drive_path(checks: Checks, path: str, exp, tests, images):
    from multimodalpromptretrieval_tpu_torch.ops import _build
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer

    server = MPRServer(exp)
    names = [e["image_name"] for e in tests]
    unique = list(dict.fromkeys(names))
    questions = [e["question"] for e in tests]
    tasks = [e["task"] for e in tests]
    B = exp.batch_size
    split = 2 * B
    staged = np.stack([images[n] for n in unique])

    def serve_window():
        """Stage the images, then two submits, the second queued behind
        the first."""
        server.stage_images(staged, unique)
        first = server.submit(None, questions[:split], tasks[:split],
                              image_ids=names[:split])
        second = server.submit(None, questions[split:], tasks[split:],
                               image_ids=names[split:])
        return first.result() + second.result()

    serve_window()  # warm-up: allocator, cuBLAS heuristics, every width
    server.chunks = {"fused": 0, "host": 0}
    server.decode_steps = 0
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    answers = serve_window()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()

    n = len(questions)
    print(f"{path} path: {len(unique)} images staged, {n} questions in "
          f"2 submits, {seconds:.3f} s", flush=True)
    checks.expect(len(answers) == n and all(isinstance(a, str)
                                            for a in answers),
                  f"answers: {len(answers)} of {n}")
    n_chunks = -(-split // B) + -(-(n - split) // B)
    checks.expect(server.chunks == {"fused": n_chunks, "host": 0},
                  f"fused path engaged: {server.chunks}")
    print(f"  decode steps run: {server.decode_steps} over {n_chunks} "
          "chunks")
    for name in PATH_KERNELS[path]:
        checks.expect(launches[name] > 0,
                      f"{name} launches in the {path} path: "
                      f"{launches[name]}")
    _, emb, pref = server._staged
    checks.expect(bool(torch.isfinite(emb).all()
                       and torch.isfinite(pref).all()),
                  f"staged tables finite: emb {tuple(emb.shape)}, "
                  f"prefix {tuple(pref.shape)}")
    print(f"  e2e: {n / seconds:.1f} QA/s on {torch.cuda.get_device_name(0)}"
          " (staging + 2 submits, bf16, B=512, k=1)", flush=True)
    return launches


def check_small_input(checks: Checks, path: str, exp, tests,
                      images) -> None:
    """The kernel path (card, fp32) against the plain versions (CPU,
    fp32) on 8 requests, under the path's config: CLIP towers, T5 encoder
    and greedy ids."""
    from multimodalpromptretrieval_tpu_torch.models import clip, mprgen, t5
    from multimodalpromptretrieval_tpu_torch.serve import (
        image_embed_prefix_step,
    )

    cfg = dataclasses.replace(exp.model_cfg, compute_dtype="float32")
    entries = tests[:8]
    imgs = torch.from_numpy(np.stack([images[e["image_name"]]
                                      for e in entries]))
    cids = torch.from_numpy(clip.truncate_text_ids(
        exp.clip_tokenizer.tokenize([e["question"] for e in entries])))
    rows, lens = exp.tokenizer.encode_rows(
        [f"Answer the {e['task']} question: " + e["question"]
         for e in entries])
    ids = torch.from_numpy(rows)
    mask = (torch.arange(ids.shape[1])[None, :]
            < torch.from_numpy(lens)[:, None]).to(torch.int32)
    cpu_params = copy.deepcopy(exp.params).cpu()
    outs = {}
    for where, params in (("card", exp.params), ("cpu", cpu_params)):
        dev = params.t5.shared.device
        with torch.inference_mode():
            emb, pref = image_embed_prefix_step(params, cfg, imgs.to(dev))
            txt = clip.clip_encode_text(params.clip, cfg.clip, cids.to(dev))
            embeds = torch.cat([pref, params.t5.shared[ids.to(dev).long()]],
                               dim=1)
            full = torch.cat([torch.ones(pref.shape[:2], dtype=mask.dtype),
                              mask], dim=1).to(dev)
            enc = t5.t5_encode(params.t5, cfg.t5, embeds, full)
            toks = mprgen.generative_predict_from_prefix(
                params, cfg, pref, ids.to(dev), mask.to(dev))
        outs[where] = [x.cpu() for x in (emb, pref, txt, enc, toks)]
    for name, a, b in zip(("image embedding", "prefix", "text embedding",
                           "T5 encoder hidden"), outs["card"], outs["cpu"]):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        checks.expect(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                      f"{path} path small input, {name} {tuple(a.shape)}: "
                      f"card vs cpu max_abs_err {err:.3g} (tol 1e-4 x "
                      f"{scale:.3g})")
    same = torch.equal(outs["card"][4], outs["cpu"][4])
    checks.expect(same, f"{path} path small input, greedy ids "
                  f"{tuple(outs['card'][4].shape)} identical on card and cpu")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    from multimodalpromptretrieval_tpu_torch.ops import _build

    t0 = time.time()
    path = _build.library_path()
    _build.library()
    print(f"built {path} with nvcc ({' '.join(_build.NVCC_FLAGS)}) "
          f"in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    from multimodalpromptretrieval_tpu_torch.ops import norm

    x = torch.ones((4, 8), device=dev)
    norm.fused_layer_norm(x, x[0], x[0])
    norm.fused_rms_norm(x, x[0])
    torch.cuda.synchronize()
    print(f"first Triton norm kernels compiled in {time.time() - t0:.1f} s",
          flush=True)

    checks = Checks()
    check_kernels(checks, dev)
    launches, params = {}, None
    for path in PATH_KERNELS:
        exp, tests, images = serving_setup(args.seed, dev, path, params)
        launches[path] = drive_path(checks, path, exp, tests, images)
        check_small_input(checks, path, exp, tests, images)
        params = exp.params  # same seed, same weights: init once
        del exp

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:",
              file=sys.stderr)
        for f in checks.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    path_of = {}
    for path, names in PATH_KERNELS.items():
        for name in names:
            path_of.setdefault(name, path)
    kernels = [dict(name=name, **meta, launches=launches[path_of[name]][name],
                    **checks.results[name]) for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
