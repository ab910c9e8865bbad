"""Triton kernels behind ``ops/norm.py`` (imported only on the card).

Replace the Pallas kernels ``_ln_kernel`` / ``_rms_kernel`` via ``_run``
(``multimodalpromptretrieval_tpu/ops/norm.py``), the normalisations of the
CLIP blocks and the T5 encoder.

What bounds them on the H100: a normalisation does a handful of flops per
element, so it is bound by device-memory bandwidth; the one thing that
counts is touching each element once (read once, write once) instead of
the several passes of separate mean / variance / affine operations.

Design: one program per block of ``ROWS`` rows; the whole row (width padded
to a power of two ``BLOCK_W``, masked) is in registers, so mean, variance
and the affine step happen in one pass. The width is any value (the TPU
kernel needed W % 128 == 0); the affine step rounds as the plain version
does (normalised row cast to the input dtype; bf16 products and sums
rounded after each operation). ``div_rn`` / ``sqrt_rn`` keep the
correctly rounded fp32 division and square root (Triton's defaults are the
approximate ones).
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def _layer_norm_kernel(x_ptr, w_ptr, b_ptr, y_ptr, n_rows, width, eps,
                       ROWS: tl.constexpr, BLOCK_W: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_W)
    col_ok = cols < width
    ok = (rows[:, None] < n_rows) & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * width + cols[None, :]
    x = tl.load(x_ptr + offs, mask=ok, other=0.0)
    x32 = x.to(tl.float32)
    n = tl.zeros_like(tl.sum(x32, axis=1)) + width
    mean = tl.div_rn(tl.sum(x32, axis=1), n)
    xc = tl.where(ok, x32 - mean[:, None], 0.0)
    var = tl.div_rn(tl.sum(xc * xc, axis=1), n)
    inv = tl.div_rn(tl.full(var.shape, 1.0, tl.float32), tl.sqrt_rn(var + eps))
    y = (xc * inv[:, None]).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0)
    b = tl.load(b_ptr + cols, mask=col_ok, other=0.0)
    yw = (y.to(tl.float32) * w.to(tl.float32)[None, :]).to(x.dtype)
    out = (yw.to(tl.float32) + b.to(tl.float32)[None, :]).to(x.dtype)
    tl.store(y_ptr + offs, out, mask=ok)


@triton.jit
def _rms_norm_kernel(x_ptr, w_ptr, y_ptr, n_rows, width, eps,
                     ROWS: tl.constexpr, BLOCK_W: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_W)
    col_ok = cols < width
    ok = (rows[:, None] < n_rows) & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * width + cols[None, :]
    x = tl.load(x_ptr + offs, mask=ok, other=0.0)
    x32 = x.to(tl.float32)
    n = tl.zeros_like(tl.sum(x32, axis=1)) + width
    var = tl.div_rn(tl.sum(x32 * x32, axis=1), n)
    inv = tl.div_rn(tl.full(var.shape, 1.0, tl.float32), tl.sqrt_rn(var + eps))
    y = (x32 * inv[:, None]).to(x.dtype)
    w = tl.load(w_ptr + cols, mask=col_ok, other=0.0)
    out = (w.to(tl.float32)[None, :] * y.to(tl.float32)).to(x.dtype)
    tl.store(y_ptr + offs, out, mask=ok)


def _grid(x2d):
    n_rows, width = x2d.shape
    block_w = triton.next_power_of_2(width)
    rows = max(1, min(16, 8192 // block_w))
    num_warps = 8 if block_w >= 1024 else 4
    return (triton.cdiv(n_rows, rows),), rows, block_w, num_warps


def layer_norm(x2d, w, b, y, eps: float) -> None:
    grid, rows, block_w, num_warps = _grid(x2d)
    _layer_norm_kernel[grid](x2d, w, b, y, x2d.shape[0], x2d.shape[1],
                             eps, ROWS=rows, BLOCK_W=block_w,
                             num_warps=num_warps)


def rms_norm(x2d, w, y, eps: float) -> None:
    grid, rows, block_w, num_warps = _grid(x2d)
    _rms_norm_kernel[grid](x2d, w, y, x2d.shape[0], x2d.shape[1], eps,
                           ROWS=rows, BLOCK_W=block_w, num_warps=num_warps)
