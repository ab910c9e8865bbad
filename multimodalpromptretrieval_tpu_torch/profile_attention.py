"""Where the attention kernels spend their time, by ``torch.profiler``.

    python3 -m multimodalpromptretrieval_tpu_torch.profile_attention \
        [--kernel long|short] [--out profile_attention.json]

``--kernel long`` (the default): ``row_attention_packed`` (K1) and
``flash_attention`` (K8) at the T5 encoder's shapes, bf16, once as the
encoder calls them (bias and key mask) and once with neither. The difference
is what the bias and mask reads cost; the operations and bytes of each call,
over the time, say how far the rest is from the card's rates.

``--kernel short``: ``short_attention`` (K9) at its four shapes, bf16 and
fp32, beside ``row_attention`` (K5) on the same packed rows (K9 reads them
as (B, H, L, 64) head views, K5 as three (B, L, W) column slices; neither
copies), so that the two kernels of the same function are compared in one
call.

Device time per kernel name over 10 calls after 2 warm-ups. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from multimodalpromptretrieval_tpu_torch.ops import (
    attention,
    row_attention,
    short_attention,
)

SHAPES = ((512, 82), (128, 562))  # (batch, length) of the T5 encoder, 8 heads
H, DH = 8, 64
SHORT_SHAPES = (  # name, batch, heads, length, scale
    ("vit", 512, 12, 50, 64 ** -0.5),
    ("text", 512, 8, 16, 64 ** -0.5),
    ("t5_enc_L82", 128, 8, 82, 1.0),
    ("L128", 128, 8, 128, 64 ** -0.5),
)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time per call of the attention kernel ``fn`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "attention" in e.key and "kernel" in e.key)
    if us <= 0:
        raise RuntimeError("the profiler recorded no attention kernel time")
    return us / iters / 1e3


def long_rows(gen, dev) -> list:
    rows = []
    for B, L in SHAPES:
        qkv = torch.randn((B, L, 3, H, DH), generator=gen,
                          device=dev).bfloat16()
        packed = qkv.view(B, L, 3 * H * DH)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias16 = torch.randn((H, L, L), generator=gen, device=dev).bfloat16()
        bias32 = bias16.float()[None]
        lens = torch.randint(L // 2, L + 1, (B,), generator=gen, device=dev)
        mask = (torch.arange(L, device=dev)[None] < lens[:, None]).int()
        flops = 4.0 * B * H * L * L * DH
        nbytes = 2 * (packed.numel() + B * L * H * DH)
        for with_bias in (True, False):
            b16, b32, m = ((bias16, bias32, mask) if with_bias
                           else (None, None, None))
            with torch.no_grad():
                k1 = device_ms(lambda: row_attention.row_attention_packed(
                    packed, b16, m, heads=H, scale=1.0))
                k8 = device_ms(lambda: attention.flash_attention(
                    q, k, v, b32, m, scale=1.0))
            for name, ms in (("row_attention_packed", k1),
                             ("flash_attention", k8)):
                row = dict(kernel=name, B=B, L=L, bias_and_mask=with_bias,
                           ms=ms, tflops=flops / ms / 1e9,
                           qkv_out_gb_per_s=nbytes / ms / 1e6)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def short_rows(gen, dev) -> list:
    rows = []
    for name, B, heads, L, scale in SHORT_SHAPES:
        W = heads * DH
        for dt in (torch.bfloat16, torch.float32):
            qkv = torch.randn((B, L, 3, heads, DH), generator=gen,
                              device=dev).to(dt)
            hq, hk, hv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            packed = qkv.view(B, L, 3 * W)
            rq, rk, rv = (packed[..., i * W:(i + 1) * W] for i in range(3))
            nbytes = qkv.element_size() * (qkv.numel() + B * L * W)
            with torch.no_grad():
                k9 = device_ms(lambda: short_attention.short_attention(
                    hq, hk, hv, scale=scale))
                k5 = device_ms(lambda: row_attention.row_attention(
                    rq, rk, rv, heads=heads, scale=scale))
            for kernel, ms in (("short_attention", k9),
                               ("row_attention", k5)):
                row = dict(kernel=kernel, shape=name, dtype=str(dt)[6:], B=B,
                           H=heads, L=L, ms=ms,
                           qkv_out_gb_per_s=nbytes / ms / 1e6)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=("long", "short"),
                        default="long")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = (long_rows if args.kernel == "long" else short_rows)(gen, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel": args.kernel, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
