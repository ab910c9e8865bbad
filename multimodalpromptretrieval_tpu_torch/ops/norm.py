"""Fused single-pass LayerNorm / RMSNorm (kernels K2 / K3).

Counterparts of ``fused_layer_norm`` / ``fused_rms_norm`` in
``multimodalpromptretrieval_tpu/ops/norm.py``, with the numerics of
``ops/layers.layer_norm`` / ``rms_norm``: fp32 mean and variance,
``1 / sqrt(var + eps)`` (not an approximate rsqrt), the normalised row
cast to the input dtype, then the affine step in that dtype.

The wrappers dispatch on the device only: a CPU tensor takes the plain
version, a CUDA tensor launches the Triton kernel of ``_norm_triton`` (any
width, any row count) or raises. ``triton`` is imported only there, when a
kernel is launched.
"""

from __future__ import annotations

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build
from multimodalpromptretrieval_tpu_torch.ops.layers import layer_norm, rms_norm

_DTYPES = (torch.float32, torch.bfloat16)


# the plain PyTorch versions of the two kernels
fused_layer_norm_reference = layer_norm
fused_rms_norm_reference = rms_norm


def _rows(name, x, *vecs):
    _build.require_cuda(name, x, *vecs)
    W = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} is not supported")
    for v in vecs:
        if v.dtype != x.dtype or tuple(v.shape) != (W,):
            raise ValueError(f"{name}: affine vector {tuple(v.shape)} "
                             f"{v.dtype} does not match ({W},) {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    return x.reshape(-1, W)


def fused_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in one pass per row block."""
    if x.device.type == "cpu":
        return fused_layer_norm_reference(x, w, b, eps)
    from multimodalpromptretrieval_tpu_torch.ops import _norm_triton

    x2 = _rows("fused_layer_norm", x, w, b)
    y = torch.empty_like(x2)
    _norm_triton.layer_norm(x2, w.contiguous(), b.contiguous(), y, eps)
    _build.count_launch("fused_layer_norm")
    return y.reshape(x.shape)


def fused_rms_norm(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """T5 RMSNorm over the last axis in one pass per row block."""
    if x.device.type == "cpu":
        return fused_rms_norm_reference(x, w, eps)
    from multimodalpromptretrieval_tpu_torch.ops import _norm_triton

    x2 = _rows("fused_rms_norm", x, w)
    y = torch.empty_like(x2)
    _norm_triton.rms_norm(x2, w.contiguous(), y, eps)
    _build.count_launch("fused_rms_norm")
    return y.reshape(x.shape)
