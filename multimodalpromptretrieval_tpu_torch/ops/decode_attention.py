"""Single-query attention for the greedy decode loop, over row caches.

Counterpart of ``decode_attention_reference`` in
``multimodalpromptretrieval_tpu/ops/decode_attention.py``: q (B, W),
k / v (B, T, W) row caches (W = heads * head_dim, no head transposes),
optional (H, T) additive bias and (B, T) key mask -> (B, W).

Plain PyTorch. The JAX default ``decode_attention_impl="indicator"`` is an
XLA-only rewrite of this same computation for the TPU and is not ported;
the Hopper decode kernel is queued (ROADMAP B4).

Rounding follows the JAX reference: the score contraction and P.V produce
the compute dtype (fp32 accumulation, one rounding), softmax runs in fp32,
and the probabilities are rounded to the compute dtype before P.V.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e9


def decode_attention_reference(q, k, v, bias=None, kv_mask=None, *,
                               heads: int, scale: float = 1.0):
    B, T, W = k.shape
    Dh = W // heads
    qh = q.reshape(B, heads, 1, Dh)
    kh = k.to(q.dtype).reshape(B, T, heads, Dh).permute(0, 2, 3, 1)
    vh = v.reshape(B, T, heads, Dh).transpose(1, 2)
    s = torch.matmul(qh, kh).float()[:, :, 0, :]  # (B, H, T)
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias[None].float()
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, :] == 0, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(p[:, :, None, :], vh.to(q.dtype))  # (B, H, 1, Dh)
    return o.reshape(B, W)
