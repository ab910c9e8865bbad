"""Where the attention kernels spend their time, by ``torch.profiler``.

    python3 -m multimodalpromptretrieval_tpu_torch.profile_attention \
        [--kernel long|short|decode] [--earlier DIR] \
        [--variant NAME:kConst=VALUE,...] [--out profile_attention.json]

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

``--kernel decode``: ``decode_attention`` (K6) and
``decode_attention_fused`` (K7) at the decode loop's shapes (t5-small's
serving chunk, the eval phase's batch of one, t5-large's chunk; self- and
cross-attention; bf16 and fp32), each with its bound (the K and V caches,
q, bias, mask and output over 3.35 TB/s) and the wrapper's host time per
call over 1,000 calls that nothing synchronises (5 runs, their median).
``--earlier DIR``: the kernel sources of another checkout of the repo at
DIR (``csrc/``, only read) are built by this checkout's ``ops/_build.py``
into ``_build/earlier/`` and go under the same wrappers too. ``--variant
NAME:kConst=VALUE,...`` (repeatable) does the same for this checkout's
sources with ``constexpr`` constants of ``decode_attention.cu`` set to
other values, into ``_build/variants/NAME/``. The libraries take turns at
every case (earlier, this, each variant, then the same in reverse), so
that the host's drift falls on all of them; each one's registers and spill
bytes per kernel instantiation, by ``nvcc -Xptxas -v``, are printed and
written out beside the times.

Device time per kernel name over 10 calls after 2 warm-ups. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import time

import torch

from multimodalpromptretrieval_tpu_torch.ops import (
    _build,
    attention,
    decode_attention,
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
DECODE_SHAPES = (  # name, batch, heads, keys, self (bias) or cross (mask)
    ("main self", 512, 8, 20, "self"),
    ("main cross", 512, 8, 82, "cross"),
    ("eval cross", 1, 8, 82, "cross"),
    ("t5_large self", 128, 16, 20, "self"),
    ("t5_large cross", 128, 16, 114, "cross"),
)
HBM_BYTES_PER_S = 3.35e12


def device_ms(fn, iters: int = 10, warmup: int = 2, tries: int = 3,
              launches: int | None = None) -> float:
    """Mean device time per call of the attention kernel ``fn`` launches.
    A trace that holds no kernel time, or (given ``launches``, the kernels
    a call launches) fewer kernels than the calls launched, is taken again,
    up to ``tries`` traces: CUPTI now and then records none or only some."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "attention" in e.key and "kernel" in e.key]
        us = sum(e.device_time_total for e in events)
        if us > 0 and (launches is None or
                       sum(e.count for e in events) == launches * iters):
            return us / iters / 1e3
    raise RuntimeError("the profiler recorded no attention kernel time"
                       if launches is None else
                       f"the profiler recorded no trace of {iters} calls")


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


def host_us(fn, calls: int = 1000, runs: int = 5) -> list:
    """Host time per call of ``fn`` over ``calls`` calls that nothing
    synchronises, once for each of ``runs`` runs (the host is shared: its
    times spread)."""
    out = []
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def earlier_sources(root: str) -> tuple:
    """The kernel sources of the checkout at ``root`` (only read) and the
    build dir of this checkout where they are built."""
    return (os.path.join(root, "multimodalpromptretrieval_tpu_torch", "csrc"),
            os.path.join(_build.BUILD_DIR, "earlier"))


def variant_sources(name: str, consts: dict) -> tuple:
    """A copy of this checkout's kernel sources under
    ``_build/variants/<name>/`` with the ``constexpr`` constants ``consts``
    of ``decode_attention.cu`` set to other values; its dir and build
    dir."""
    out = os.path.join(_build.BUILD_DIR, "variants", name)
    csrc = os.path.join(out, "csrc")
    os.makedirs(csrc, exist_ok=True)
    for f in _build.SOURCES + _build.HEADERS:
        shutil.copy(os.path.join(_build.CSRC, f), csrc)
    path = os.path.join(csrc, "decode_attention.cu")
    with open(path) as f:
        src = f.read()
    for const, value in consts.items():
        src, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions of {const}")
    with open(path, "w") as f:
        f.write(src)
    return csrc, out


def parse_variant(arg: str):
    """``NAME:kA=1,kB=2`` -> (NAME, {kA: 1, kB: 2})."""
    name, _, consts = arg.partition(":")
    return name, dict(c.split("=", 1) for c in consts.split(",") if c)


def kernel_registers(csrcs: dict) -> dict:
    """Registers and spill bytes of each instantiation of the decode
    attention kernel, by ``nvcc -Xptxas -v``, for each source dir (compiled
    in parallel)."""
    procs = {lib: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         os.devnull, os.path.join(csrc, "decode_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib, csrc in csrcs.items()}
    out = {}
    for lib, p in procs.items():
        log = p.communicate()[0]
        got, kernel = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*"
                          r"decode_attention_kernelI(\w+?)EvPK", line)
            if m:  # template arguments: dtype, products rounded, staged
                dt = "bf16" if "bfloat16" in m.group(1) else "fp32"
                flags = re.findall(r"Lb([01])E", m.group(1))
                kernel = " ".join([dt, "K7" if flags[:1] == ["1"] else "K6"]
                                  + ["staged"] * (flags[1:] == ["1"]))
            m = re.search(r"(\d+) bytes spill stores", line)
            if kernel and m:
                got[kernel] = dict(spill_store_bytes=int(m.group(1)))
            m = re.search(r"Used (\d+) registers", line)
            if kernel and m:
                got.setdefault(kernel, {})["registers"] = int(m.group(1))
                kernel = None
        out[lib] = got
        print(lib, "registers", json.dumps(got), flush=True)
    return out


def decode_rows(gen, dev, earlier=None, variants=()) -> tuple:
    dirs = {"this": (_build.CSRC, _build.BUILD_DIR)}
    if earlier is not None:
        dirs = {"earlier": earlier_sources(earlier), **dirs}
    for arg in variants:
        name, consts = parse_variant(arg)
        dirs[name] = variant_sources(name, consts)
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        paths = list(pool.map(lambda d: _build.library_path(*d),
                              dirs.values()))
    libs = {lib: _build.load(path) for lib, path in zip(dirs, paths)}
    registers = kernel_registers({lib: c for lib, (c, _) in dirs.items()})
    order = list(libs) + list(libs)[::-1]
    rows = []
    try:
        for name, B, heads, T, kind in DECODE_SHAPES:
            W = heads * DH
            for dt in (torch.bfloat16, torch.float32):
                k, v = (torch.randn((B, T, W), generator=gen,
                                    device=dev).to(dt) for _ in range(2))
                bias = mask = None
                if kind == "self":  # q a column slice of the qkv rows
                    q = torch.randn((B, 3 * W), generator=gen,
                                    device=dev).to(dt)[:, :W]
                    bias = torch.randn((heads, T), generator=gen, device=dev)
                else:
                    q = torch.randn((B, W), generator=gen, device=dev).to(dt)
                    lens = torch.randint(T // 2, T + 1, (B,), generator=gen,
                                         device=dev)
                    mask = (torch.arange(T, device=dev)[None]
                            < lens[:, None]).int()
                nbytes = sum(t.numel() * t.element_size()
                             for t in (q, k, v, bias, mask) if t is not None)
                nbytes += B * W * k.element_size()  # the output
                for kernel in ("decode_attention", "decode_attention_fused"):
                    fn = getattr(decode_attention, kernel)
                    call = lambda: fn(  # noqa: E731
                        q, k, v, bias, mask, heads=heads)
                    got = {lib: dict(ms=[], host_us_runs=[]) for lib in libs}
                    for lib in order:
                        _build._lib = libs[lib]
                        with torch.no_grad():
                            got[lib]["ms"].append(
                                device_ms(call, launches=1))
                            got[lib]["host_us_runs"] += host_us(call)
                    row = dict(kernel=kernel, shape=name, dtype=str(dt)[6:],
                               B=B, H=heads, T=T,
                               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
                    for lib, g in got.items():
                        us = sorted(g["host_us_runs"])
                        prefix = "" if lib == "this" else lib + "_"
                        row.update({prefix + "ms": min(g["ms"]),
                                    prefix + "ms_runs": g["ms"],
                                    prefix + "host_us_per_call":
                                        us[len(us) // 2],
                                    prefix + "host_us_runs":
                                        g["host_us_runs"]})
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        _build._lib = libs["this"]
    return rows, registers


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=("long", "short", "decode"),
                        default="long")
    parser.add_argument("--earlier", default=None,
                        help="another checkout of the repo (decode only)")
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME:kConst=VALUE,... (decode only)")
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
    extra = {}
    if args.kernel == "decode":
        rows, extra["registers"] = decode_rows(gen, dev, args.earlier,
                                               args.variant)
    else:
        rows = (long_rows if args.kernel == "long" else short_rows)(gen, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernel": args.kernel, "rows": rows,
                       **extra}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
