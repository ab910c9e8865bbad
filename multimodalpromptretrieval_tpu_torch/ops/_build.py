"""Build and load the hand-written CUDA kernels; count kernel launches.

The CUDA sources live in ``csrc/``. They have a plain C interface (no
PyTorch headers): one ``nvcc`` per source, all started together, compiles
them for ``sm_90a`` in seconds, and one more links them into a shared
library. The library is cached under ``_build/`` by a hash of the sources
and the headers they include (``HEADERS``) and loaded with ctypes; a rebuild
happens only when one of them changes.
Nothing is compiled or loaded at import time: the first launch of a CUDA
kernel builds the library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

``LAUNCHES`` counts, per kernel, how often its wrapper launched it on the
card (CPU tensors take the plain versions and are not counted), so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("row_attention.cu", "l2_topk.cu", "decode_attention.cu",
           "flash_attention.cu", "short_attention.cu", "moe_experts.cu",
           "mla_decode.cu")
# headers the sources include: part of the source hash, not compiled alone
HEADERS = ("attention_tiles.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"row_attention_packed": 0, "fused_layer_norm": 0,
            "fused_rms_norm": 0, "l2_topk": 0, "row_attention": 0,
            "decode_attention": 0, "decode_attention_fused": 0,
            "flash_attention": 0, "short_attention": 0, "moe_experts": 0,
            "mla_decode_attention": 0}

_lock = threading.Lock()
_COUNT_LOCK = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, (batch, row) strides of q, of k and of v, bias, bias dtype,
    # mask, out, B, L, H, Dh, scale, causal, dtype, stream
    "mpr_row_attention": [_P, _P, _P] + [_I64] * 6 + [
        _P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # query, index, index_sq, B, N, D, k, scratch, out d/i, squared, stream
    "mpr_l2_topk": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    # q, k, v, q batch stride, k batch/row, v batch/row strides, bias,
    # mask, out, B, T, H, Dh, scale, round_products, dtype, stream
    "mpr_decode_attention": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P,
                             _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, their (batch, head, row) strides, bias, bias B / H, mask,
    # out, B, H, Lq, Lk, Dh, scale, causal, block_q, block_k, dtype, stream
    "mpr_flash_attention": [_P, _P, _P] + [_I64] * 9 + [
        _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    # q, k, v, (batch, head, row) strides of q, of k and of v, out,
    # B, H, L, Dh, scale, dtype, stream
    "mpr_short_attention": [_P, _P, _P] + [_I64] * 9 + [
        _P, _I, _I, _I, _I, _F, _I, _P],
    # h, gate_up, down, rows, tile_expert, weight, act, out, N, top_k, d,
    # I, tiles, block_m, dtype, stream
    "mpr_moe_experts": [_P] * 8 + [_I] * 7 + [_P],
    # q_lat, q_pe, cache, key_ok, out, q_lat (batch, head), q_pe (batch,
    # head), cache (batch, token) and key_ok batch strides, B, H, C, R,
    # length, scale, dtype, stream
    "mpr_mla_decode_attention": [_P] * 5 + [_I64] * 7 + [_I] * 5 + [
        _F, _I, _P],
    "mpr_row_attention_max_len": [_I],  # head dim
    "mpr_l2_topk_scratch_cols": [_I],  # N
    "mpr_decode_attention_max_len": [_I],  # heads
    "mpr_flash_attention_max_cols": [_I],  # head dim
}


def count_launch(name: str) -> None:
    # a server's dispatcher thread and its caller both launch kernels
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(csrc: str = CSRC, build_dir: str = BUILD_DIR) -> str:
    """Path of the library compiled from ``SOURCES`` in ``csrc`` into
    ``build_dir``, building it if it is missing."""
    srcs = [os.path.join(csrc, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(csrc, s) for s in HEADERS]:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    path = os.path.join(build_dir, f"libmprkernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    # one compiler per source, all at once; then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(srcs, objs)]
    failed = []
    for s, p in zip(srcs, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)} ({p.returncode}):\n{out}")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stdout}{link.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing
    return path


def load(path: str) -> ctypes.CDLL:
    """The kernel library at ``path``, its entry points typed."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # ctypes would pass a Python int as a 32-bit int and cut a pointer:
    # every pointer and the stream are c_void_p above
    lib.mpr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(library_path())
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().mpr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_no_grad(name: str, *tensors) -> None:
    """A forward-only kernel must not sit in an autograd graph: its output
    would carry no gradient, silently."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only (the JAX kernel it replaces defines no "
            "gradient here): call it under torch.no_grad(), or train with "
            "attention_impl \"row\" or \"xla\"")


def require_cuda(name: str, *tensors) -> None:
    """Kernels run only on CUDA tensors, all on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(
                f"{name}: the kernel runs on CUDA tensors, got {t.device}")
        if t.device != dev:
            raise RuntimeError(f"{name}: tensors on {dev} and {t.device}")
