"""Row-layout attention over the fused QKV GEMM output (kernel K1).

Counterpart of ``row_attention_packed`` in
``multimodalpromptretrieval_tpu/ops/row_attention.py``: ``qkv`` is the
(B, L, 3W) output of one fused q/k/v projection, [q | k | v] column groups
with W = heads * head_dim; the result is (B, L, W) rows, ready for the
out-projection. No head transposes, no split copies.

Math (both versions): fp32 scores ``q . k * scale`` (T5 passes 1.0, CLIP
1/sqrt(head_dim)), plus an optional (H, L, L) additive bias; a zero in the
optional (B, L) key mask replaces the score with -1e9, and ``causal`` adds
-1e9 to future keys (-1e9, not -inf: a fully masked row is uniform, not
NaN); exact softmax; probabilities rounded to the value dtype before P.V,
which accumulates in fp32.

``row_attention_packed`` dispatches on the device only: a CPU tensor takes
:func:`row_attention_packed_reference`, a CUDA tensor launches
``csrc/row_attention.cu`` or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is instantiated for the serving towers' one head dim
_HEAD_DIMS = (64,)


def row_attention_packed_reference(
        qkv: torch.Tensor, bias: Optional[torch.Tensor] = None,
        kv_mask: Optional[torch.Tensor] = None, *, heads: int, scale: float,
        causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature and layout)."""
    B, L, W3 = qkv.shape
    W = W3 // 3
    Dh = W // heads

    def heads_of(x):
        return x.reshape(B, L, heads, Dh).transpose(1, 2)

    q, k, v = (heads_of(x) for x in qkv.split(W, dim=-1))
    # bf16 x bf16 products are exact in fp32: an fp32 product of the
    # upcast operands is the fp32-accumulated dot of the kernel
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()[None]
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    if causal:
        pos = torch.arange(L, device=qkv.device)
        s = s + torch.where(pos[None, :] <= pos[:, None], 0.0, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(qkv.dtype)
    return o.transpose(1, 2).reshape(B, L, W)


def row_attention_packed(qkv: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         kv_mask: Optional[torch.Tensor] = None, *,
                         heads: int, scale: float,
                         causal: bool = False) -> torch.Tensor:
    """qkv (B, L, 3W) -> (B, L, W); bias (heads, L, L); kv_mask (B, L)."""
    if qkv.device.type == "cpu":
        return row_attention_packed_reference(
            qkv, bias, kv_mask, heads=heads, scale=scale, causal=causal)
    name = "row_attention_packed"
    _build.require_cuda(name, qkv, *(t for t in (bias, kv_mask)
                                     if t is not None))
    B, L, W3 = qkv.shape
    if W3 % 3 or (W3 // 3) % heads:
        raise ValueError(f"{name}: width {W3} is not 3 * heads * head_dim")
    W = W3 // 3
    Dh = W // heads
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {qkv.dtype} is not supported")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {_HEAD_DIMS}")
    if B > 65535:  # the grid's z dimension is the sequence index
        raise ValueError(f"{name}: batch {B} exceeds 65535")
    lib = _build.library()
    if L > lib.mpr_row_attention_max_len(Dh):
        raise ValueError(f"{name}: L={L} exceeds the shared-memory score "
                         f"block ({lib.mpr_row_attention_max_len(Dh)})")
    bias32 = mask32 = None
    if bias is not None:
        if tuple(bias.shape) != (heads, L, L):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                             f"{(heads, L, L)}")
        bias32 = bias.to(torch.float32).contiguous()
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, L):
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is "
                             f"not {(B, L)}")
        mask32 = kv_mask.to(torch.int32).contiguous()
    out = torch.empty((B, L, W), dtype=qkv.dtype, device=qkv.device)
    base, es = qkv.data_ptr(), qkv.element_size()
    code = lib.mpr_row_attention(
        base, base + W * es, base + 2 * W * es, L * W3, W3, L * W3, W3,
        None if bias32 is None else bias32.data_ptr(),
        None if mask32 is None else mask32.data_ptr(),
        out.data_ptr(), B, L, heads, Dh, float(scale), int(causal),
        _DTYPE_CODES[qkv.dtype], _build.stream_handle(qkv))
    _build.check(code, name)
    _build.count_launch(name)
    return out
