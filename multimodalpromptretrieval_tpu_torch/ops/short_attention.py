"""Short-sequence attention per (batch, head) (kernel K9).

Counterpart of ``short_attention`` in
``multimodalpromptretrieval_tpu/ops/short_attention.py``: q, k, v
(B, H, L, Dh) with L <= 128 -> (B, H, L, Dh). The JAX kernel pads L to a
multiple of 8, packs ``group`` heads into one block-diagonal product and
masks the off-block and padded columns to -1e9, all to fill its matrix
unit; a masked score is ``exp(-1e9 - m) == 0`` in fp32, so the function it
computes is plain per-head attention over the L real keys, and that is
what the kernel and the plain version here compute: fp32 scores
``q . k * scale`` (the scale is always applied), no bias and no mask, exact
softmax, probabilities rounded to the value dtype before P.V, which
accumulates in fp32. Forward only, as in the JAX package (it defines no
gradient rule).

``short_attention`` dispatches on the device only: a CPU tensor takes
:func:`short_attention_reference`, a CUDA tensor launches
``csrc/short_attention.cu`` or raises.
"""

from __future__ import annotations

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # every tower's head dim; the kernel is written for it
MAX_LEN = 128


def _check(q, k, v):
    B, H, L, Dh = q.shape
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("short_attention: q, k and v must share shape "
                             f"and dtype, got {tuple(t.shape)} {t.dtype}")
    if L > MAX_LEN or L < 1:
        raise ValueError(f"short_attention: L={L} is not in 1..{MAX_LEN}")
    if Dh != _HEAD_DIM:
        raise ValueError(f"short_attention: head dim {Dh} is not {_HEAD_DIM}")
    return B, H, L, Dh


def short_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, scale: float,
                              group: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel; ``group`` changes nothing."""
    _check(q, k, v)
    # bf16 x bf16 products are exact in fp32: an fp32 product of the
    # upcast operands is the fp32-accumulated dot of the kernel
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, group: int = 8) -> torch.Tensor:
    """q, k, v (B, H, L, 64), L <= 128 -> (B, H, L, 64). ``group`` is the
    JAX kernel's heads-per-program packing factor: accepted, and without
    effect on the result here (the kernel packs heads by L on its own).
    Forward only: on the card, inputs that require grad raise."""
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, scale=scale)
    name = "short_attention"
    _build.require_no_grad(name, q, k, v)
    _build.require_cuda(name, q, k, v)
    B, H, L, Dh = _check(q, k, v)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} is not supported")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: unit stride along the head dim "
                             f"needed, got strides {t.stride()}")
    out = torch.empty((B, H, L, Dh), dtype=q.dtype, device=q.device)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    code = _build.library().mpr_short_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, out.data_ptr(),
        B, H, L, Dh, float(scale), _DTYPE_CODES[q.dtype],
        _build.stream_handle(q))
    _build.check(code, name)
    _build.count_launch(name)
    return out
