"""Fused single-pass LayerNorm / RMSNorm (kernels K2 / K3).

Counterparts of ``fused_layer_norm`` / ``fused_rms_norm`` in
``multimodalpromptretrieval_tpu/ops/norm.py``, with the numerics of
``ops/layers.layer_norm`` / ``rms_norm``: fp32 mean and variance,
``1 / sqrt(var + eps)`` (not an approximate rsqrt), the normalised row
cast to the input dtype, then the affine step in that dtype.

The wrappers dispatch on the device only: a CPU tensor takes the plain
version, a CUDA tensor launches the Triton kernel of ``_norm_triton`` (any
width, any row count) or raises. ``triton`` is imported only there, when a
kernel is launched. Both are differentiable through one
``torch.autograd.Function`` whose backward is the gradient of the plain
norm (the JAX package has no backward kernel either); the Function boundary
keeps autograd from tracing the Triton launch.
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


def _launch_layer_norm(x, w, b, eps):
    from multimodalpromptretrieval_tpu_torch.ops import _norm_triton

    x2 = _rows("fused_layer_norm", x, w, b)
    y = torch.empty_like(x2)
    _norm_triton.layer_norm(x2, w.contiguous(), b.contiguous(), y, eps)
    _build.count_launch("fused_layer_norm")
    return y.reshape(x.shape)


def _launch_rms_norm(x, w, eps):
    from multimodalpromptretrieval_tpu_torch.ops import _norm_triton

    x2 = _rows("fused_rms_norm", x, w)
    y = torch.empty_like(x2)
    _norm_triton.rms_norm(x2, w.contiguous(), y, eps)
    _build.count_launch("fused_rms_norm")
    return y.reshape(x.shape)


class _FusedNorm(torch.autograd.Function):
    """Forward: the Triton kernel (CUDA) or the plain norm (CPU). Backward:
    the gradient of the plain norm on the saved *inputs*, as the JAX
    package's ``jax.vjp`` of ``layer_norm`` / ``rms_norm``: ``dx``, and
    ``dw`` (and ``db``) reduced over the rows. ``vecs`` is (w, b) for
    LayerNorm and (w,) for RMSNorm."""

    @staticmethod
    def forward(ctx, eps, x, *vecs):
        ctx.save_for_backward(x, *vecs)
        ctx.eps = eps
        if x.device.type == "cpu":
            plain = layer_norm if len(vecs) == 2 else rms_norm
            return plain(x, *vecs, eps)
        launch = _launch_layer_norm if len(vecs) == 2 else _launch_rms_norm
        return launch(x, *vecs, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors  # read once (checkpointing unpacks once)
        plain = layer_norm if len(saved) == 3 else rms_norm
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need) for t, need in
                      zip(saved, ctx.needs_input_grad[1:])]
            y = plain(*inputs, ctx.eps)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (None, *(next(grads) if t.requires_grad else None
                        for t in inputs))


def fused_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in one pass per row block.
    Differentiable in x, w and b."""
    return _FusedNorm.apply(eps, x, w, b)


def fused_rms_norm(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """T5 RMSNorm over the last axis in one pass per row block.
    Differentiable in x and w."""
    return _FusedNorm.apply(eps, x, w)
