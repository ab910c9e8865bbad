"""Row-layout attention: packed QKV rows (kernel K1), separate q/k/v (K5).

Counterparts of ``row_attention_packed`` and ``row_attention`` in
``multimodalpromptretrieval_tpu/ops/row_attention.py``. K1 takes ``qkv``, the
(B, L, 3W) output of one fused q/k/v projection ([q | k | v] column groups,
W = heads * head_dim); K5 takes three separately allocated (B, L, W)
tensors and has no causal term. Both return (B, L, W) rows, ready for the
out-projection. No head transposes, no split copies.

Forward math (kernels and plain versions): fp32 scores ``q . k * scale``
(T5 passes 1.0, CLIP 1/sqrt(head_dim)), plus an optional (H, L, L) additive
bias; a zero in the optional (B, L) key mask replaces the score with -1e9,
and ``causal`` adds -1e9 to future keys (-1e9, not -inf: a fully masked
row is uniform, not NaN); exact softmax; probabilities rounded to the value
dtype before P.V, which accumulates in fp32.

Both are differentiable through one ``torch.autograd.Function``. Its
backward is the JAX package's ``_row_bwd`` / ``_packed_bwd`` in plain torch
on either device (the JAX package has no backward kernel either): the scores
are recomputed with a product in the *input* dtype and only then cast to
fp32, ``p`` is cast to the cotangent's dtype for ``dv``, ``ds * scale`` to
q's dtype for ``dq`` / ``dk``, ``d_bias`` is the fp32 sum of ``ds`` over
the batch cast to the bias dtype, and the causal term enters the recompute
as an added (H, L, L) bias that gets no gradient of its own. At fp32 these
orders do not matter; at bf16 they are the function.

The forward dispatches on the device only: a CPU tensor takes the plain
version, a CUDA tensor launches ``csrc/row_attention.cu`` or raises. The
kernel runs both products on the tensor cores for bf16 inputs and in full
fp32 on the CUDA cores for fp32 inputs, and takes rows up to L = 1,536.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is instantiated for the towers' one head dim
_HEAD_DIMS = (64,)


def _heads_of(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, W) rows -> a (B, H, L, Dh) view."""
    B, L, W = x.shape
    return x.reshape(B, L, heads, W // heads).transpose(1, 2)


def _causal_bias(L: int, device) -> torch.Tensor:
    pos = torch.arange(L, device=device)
    return torch.where(pos[None, :] <= pos[:, None], 0.0, _NEG_INF)


def row_attention_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None, *, heads: int, scale: float,
        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of both kernels over (B, L, W) q, k, v rows
    (``causal`` serves the packed kernel's plain version)."""
    B, L, W = q.shape
    qh, kh, vh = (_heads_of(x, heads) for x in (q, k, v))
    # bf16 x bf16 products are exact in fp32: an fp32 product of the
    # upcast operands is the fp32-accumulated dot of the kernel
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()[None]
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    if causal:
        s = s + _causal_bias(L, q.device)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p.to(vh.dtype).float(), vh.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(B, L, W)


def row_attention_packed_reference(
        qkv: torch.Tensor, bias: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None, *, heads: int, scale: float,
        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1 (same signature and layout)."""
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return row_attention_reference(q, k, v, bias, kv_mask, heads=heads,
                                   scale=scale, causal=causal)


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias, kv_mask, heads: int, scale: float,
            causal: bool) -> torch.Tensor:
    """Check the (B, L, W) row tensors (any batch and row strides, unit
    stride along W) and launch the kernel, counted under ``name``."""
    _build.require_cuda(name, q, k, v, *(t for t in (bias, kv_mask)
                                         if t is not None))
    B, L, W = q.shape
    if W % heads:
        raise ValueError(f"{name}: width {W} is not heads * head_dim")
    Dh = W // heads
    for t in (q, k, v):
        if tuple(t.shape) != (B, L, W) or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share shape and "
                             f"dtype, got {tuple(t.shape)} {t.dtype}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}: rows must have unit stride along "
                             f"the width, got strides {t.stride()}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} is not supported")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {_HEAD_DIMS}")
    if B > 65535:  # the grid's z dimension is the sequence index
        raise ValueError(f"{name}: batch {B} exceeds 65535")
    lib = _build.library()
    if L > lib.mpr_row_attention_max_len(Dh):
        raise ValueError(f"{name}: L={L} exceeds the shared-memory score "
                         f"block ({lib.mpr_row_attention_max_len(Dh)})")
    # the kernel takes 16-byte loads where the bases and strides of q, k
    # and v allow them and 2- or 4-byte loads where not: no copy either way
    mask32 = None
    if bias is not None:
        if tuple(bias.shape) != (heads, L, L):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                             f"{(heads, L, L)}")
        # read by the kernel in the dtype it comes in (bf16 -> fp32 is
        # exact); another dtype is cast to fp32 as the plain version does
        bias = bias.detach()
        if bias.dtype not in _DTYPE_CODES:
            bias = bias.to(torch.float32)
        bias = bias.contiguous()
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, L):
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is "
                             f"not {(B, L)}")
        mask32 = kv_mask.to(torch.int32).contiguous()
    out = torch.empty((B, L, W), dtype=q.dtype, device=q.device)
    code = lib.mpr_row_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        None if bias is None else bias.data_ptr(),
        0 if bias is None else _DTYPE_CODES[bias.dtype],
        None if mask32 is None else mask32.data_ptr(),
        out.data_ptr(), B, L, heads, Dh, float(scale), int(causal),
        _DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(code, name)
    _build.count_launch(name)
    return out


def _row_bwd(q, k, v, bias, kv_mask, heads: int, scale: float, g):
    """The JAX package's ``_row_bwd``: standard attention backward with the
    scores recomputed, rounding points as listed in the module docstring.
    Returns (dq, dk, dv, d_bias or None) as (B, L, W) rows."""
    B, L, W = q.shape
    qh, kh, vh, gh = (_heads_of(x, heads) for x in (q, k, v, g))
    s = torch.matmul(qh, kh.transpose(-1, -2)).float()
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()[None]
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.to(gh.dtype).transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2)).float()
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    d_bias = None if bias is None else ds.sum(dim=0).to(bias.dtype)
    ds_scaled = (ds * scale).to(qh.dtype)
    dq = torch.matmul(ds_scaled, kh)
    dk = torch.matmul(ds_scaled.transpose(-1, -2), qh)
    return (*(x.transpose(1, 2).reshape(B, L, W) for x in (dq, dk, dv)),
            d_bias)


class _RowAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    recompute of :func:`_row_bwd`. ``packed`` reads q, k, v as column
    slices of ``a`` (and ignores ``b``, ``c``)."""

    @staticmethod
    def forward(ctx, packed, a, b, c, bias, kv_mask, heads, scale, causal):
        if packed:
            q, k, v = a.split(a.shape[-1] // 3, dim=-1)
            name = "row_attention_packed"
        else:
            q, k, v = a, b, c
            name = "row_attention"
        ctx.save_for_backward(a, b, c, bias, kv_mask)
        ctx.cfg = (packed, heads, scale, causal)
        if a.device.type == "cpu":
            return row_attention_reference(q, k, v, bias, kv_mask,
                                           heads=heads, scale=scale,
                                           causal=causal)
        return _launch(name, q, k, v, bias, kv_mask, heads, scale, causal)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b, c, bias, kv_mask = ctx.saved_tensors
        packed, heads, scale, causal = ctx.cfg
        q, k, v = a.split(a.shape[-1] // 3, dim=-1) if packed else (a, b, c)
        eff_bias = bias
        if causal:
            # the causal term of the forward, folded into an fp32 (H, L, L)
            # bias for the recompute; it gets no gradient of its own
            L = q.shape[1]
            cb = _causal_bias(L, q.device)
            eff_bias = (cb if bias is None else bias.float() + cb).expand(
                heads, L, L)
        dq, dk, dv, d_bias = _row_bwd(q, k, v, eff_bias, kv_mask, heads,
                                      scale, g)
        if bias is None:
            d_bias = None
        elif causal:
            d_bias = d_bias.to(bias.dtype)
        if packed:
            return (None, torch.cat([dq, dk, dv], dim=-1), None, None,
                    d_bias, None, None, None, None)
        return None, dq, dk, dv, d_bias, None, None, None, None


def row_attention_packed(qkv: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         kv_mask: Optional[torch.Tensor] = None, *,
                         heads: int, scale: float,
                         causal: bool = False) -> torch.Tensor:
    """K1. qkv (B, L, 3W) -> (B, L, W); bias (heads, L, L); kv_mask
    (B, L). Differentiable in ``qkv`` and ``bias``."""
    if qkv.shape[-1] % 3:
        raise ValueError(f"row_attention_packed: width {qkv.shape[-1]} is "
                         "not 3 * heads * head_dim")
    if qkv.device.type != "cpu" and not qkv.is_contiguous():
        raise ValueError("row_attention_packed: qkv must be contiguous")
    return _RowAttention.apply(True, qkv, None, None, bias, kv_mask, heads,
                               scale, causal)


def row_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  kv_mask: Optional[torch.Tensor] = None, *, heads: int,
                  scale: float) -> torch.Tensor:
    """K5. q, k, v and the result (B, L, W) with W = heads * head_dim, each
    with its own batch and row strides; bias (heads, L, L); kv_mask (B, L).
    No causal term. Differentiable in q, k, v and ``bias``."""
    return _RowAttention.apply(False, q, k, v, bias, kv_mask, heads, scale,
                               False)
