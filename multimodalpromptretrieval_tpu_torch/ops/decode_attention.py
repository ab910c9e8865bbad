"""Single-query attention for the greedy decode loop, over row caches
(kernels K6 and K7).

Counterpart of ``multimodalpromptretrieval_tpu/ops/decode_attention.py``:
q (B, W), k / v (B, T, W) row caches (W = heads * head_dim, no head
transposes), optional (H, T) additive bias and (B, T) key mask -> (B, W).

The JAX package has four names for the single-query step (``decode_attention_impl``)
and they compute one of two functions, which differ only at bf16:

  * the reference (``"xla"``, and the Pallas kernel ``decode_attention``,
    ``"pallas"``): fp32 products of q and k summed per head, the score
    rounded to the compute dtype;
  * the indicator formulation (``"indicator"``, the JAX default, and the
    Pallas kernel ``decode_attention_fused``, ``"fused"``): each q*k product
    rounded to the compute dtype BEFORE the fp32 sum, then the score rounded
    again.

Both then add the fp32 bias, mask, take an fp32 softmax over T, round the
probabilities to the compute dtype and accumulate P.V in fp32.

``decode_attention`` (K6) and ``decode_attention_fused`` (K7) dispatch on
the device only: a CPU tensor takes :func:`decode_attention_reference` /
:func:`decode_attention_indicator_reference`, a CUDA tensor launches
``csrc/decode_attention.cu`` or raises. ``out``, a contiguous (B, W)
tensor of q's dtype, receives the result in place of a new one (the
greedy decode's captured segments read it at a fixed address).
:func:`decode_attention_for` maps a ``decode_attention_impl`` name to its
wrapper.

:func:`block_attention_indicator` is the indicator function for S queries
a row (the speculative decode's verification pass), in plain torch, as the
JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is instantiated for T5's one head dim (d_kv=64 at every size)
_HEAD_DIMS = (64,)


def decode_attention_reference(q, k, v, bias=None, kv_mask=None, *,
                               heads: int, scale: float = 1.0):
    """Plain version of K6: the score contraction and P.V produce the
    compute dtype (fp32 accumulation, one rounding), softmax in fp32."""
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


def decode_attention_indicator_reference(q, k, v, bias=None, kv_mask=None,
                                         *, heads: int, scale: float = 1.0):
    """Plain version of K7, the math of JAX ``decode_attention_indicator``:
    products rounded to the compute dtype, an fp32 sum per head, the score
    rounded to the compute dtype, fp32 softmax over T, probabilities
    rounded, fp32 P.V."""
    B, T, W = k.shape
    Dh = W // heads
    dt = q.dtype
    prod = q[:, None, :] * k.to(dt)  # (B, T, W): one rounding per product
    s = prod.float().reshape(B, T, heads, Dh).sum(-1)  # (B, T, H)
    s = s.to(dt).float()
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.t()[None].float()
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, :, None] == 0, _NEG_INF)
    p = torch.softmax(s, dim=1).to(dt)  # over T
    o = (p.float()[..., None] * v.float().reshape(B, T, heads, Dh)).sum(1)
    return o.reshape(B, W).to(dt)


def block_attention_indicator(q, k, v, *, heads: int, bias=None,
                              kv_mask=None, scale: float = 1.0):
    """Block-query attention over row caches, the speculative decode's
    verification pass (JAX ``block_attention_indicator``, which runs
    outside any Pallas kernel): each of S queries a row takes K7's
    function. q (B, S, W); k, v (B, T, W); bias additive fp32
    (B, S, H, T); kv_mask (B, T) -> (B, S, W).

    Each q*k product is rounded to the compute dtype before the fp32 sum
    per head, so the scores cannot come from a matrix product: the
    (B, S, T, W) products are materialised, in the compute dtype (215 MB
    in bf16 at B=512, S=5, T=82, W=512). P.V is a matrix product in fp32,
    exact in its products as the JAX indicator product is."""
    B, S, W = q.shape
    T = k.shape[1]
    H, Dh = heads, W // heads
    dt = q.dtype
    prod = q[:, :, None, :] * k[:, None].to(dt)  # (B, S, T, W)
    s = prod.view(B, S, T, H, Dh).sum(-1, dtype=torch.float32)
    s = s.to(dt).float()  # (B, S, T, H)
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.transpose(2, 3).float()
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, :, None] == 0, _NEG_INF)
    p = torch.softmax(s, dim=2).to(dt)  # over T
    vh = v.float().view(B, T, H, Dh).transpose(1, 2)  # (B, H, T, Dh)
    o = torch.matmul(p.float().permute(0, 3, 1, 2), vh)  # (B, H, S, Dh)
    return o.transpose(1, 2).reshape(B, S, W).to(dt)


def _out(name: str, q, out):
    """``out`` checked as the (B, W) result of q, or a new one."""
    if out is None:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if (out.shape != q.shape or out.dtype != q.dtype
            or out.device != q.device or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} is not "
                         f"a contiguous, 16-byte aligned {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    return out


def _launch(name: str, q, k, v, bias, kv_mask, heads: int, scale: float,
            round_products: bool, out=None) -> torch.Tensor:
    _build.require_cuda(name, q, k, v, *(t for t in (bias, kv_mask, out)
                                         if t is not None))
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         "are not one (B, T, W)")
    B, T, W = k.shape
    if tuple(q.shape) != (B, W):
        raise ValueError(f"{name}: q {tuple(q.shape)} is not {(B, W)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                        "are not one of float32, bfloat16")
    if W % heads or W // heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim of W={W}, heads={heads} is not "
                         f"in {_HEAD_DIMS}")
    lib = _build.library()
    max_len = lib.mpr_decode_attention_max_len(heads)
    if T > max_len:
        raise ValueError(f"{name}: T={T} exceeds the shared-memory score "
                         f"rows ({max_len} at {heads} heads)")
    # 16-byte vector loads: row starts and strides aligned to 16 bytes
    vec = 16 // q.element_size()
    for t, strides in ((q, q.stride()[:1]), (k, k.stride()[:2]),
                       (v, v.stride()[:2])):
        if t.stride(-1) != 1 or t.data_ptr() % 16 \
                or any(s % vec for s in strides):
            raise ValueError(f"{name}: q / k / v need unit last stride and "
                             "16-byte aligned rows")
    bias32 = mask32 = None
    if bias is not None:
        if tuple(bias.shape) != (heads, T):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                             f"{(heads, T)}")
        bias32 = bias.to(torch.float32).contiguous()
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is "
                             f"not {(B, T)}")
        mask32 = kv_mask.to(torch.int32).contiguous()
    out = _out(name, q, out)
    code = lib.mpr_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1),
        None if bias32 is None else bias32.data_ptr(),
        None if mask32 is None else mask32.data_ptr(), out.data_ptr(),
        B, T, heads, W // heads, float(scale), int(round_products),
        _DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(code, name)
    _build.count_launch(name)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None, *, heads: int,
                     scale: float = 1.0,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6 (fp32 products). q (B, W) with any row stride; k, v (B, T, W)
    with any batch / row strides; bias (H, T); kv_mask (B, T) -> (B, W),
    written into ``out`` when given."""
    if q.device.type == "cpu":
        o = decode_attention_reference(q, k, v, bias, kv_mask, heads=heads,
                                       scale=scale)
        return o if out is None else _out("decode_attention", q,
                                          out).copy_(o)
    return _launch("decode_attention", q, k, v, bias, kv_mask, heads, scale,
                   round_products=False, out=out)


def decode_attention_fused(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           kv_mask: Optional[torch.Tensor] = None, *,
                           heads: int, scale: float = 1.0,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K7 (products rounded to the compute dtype); same signature as
    :func:`decode_attention`."""
    if q.device.type == "cpu":
        o = decode_attention_indicator_reference(
            q, k, v, bias, kv_mask, heads=heads, scale=scale)
        return o if out is None else _out("decode_attention_fused", q,
                                          out).copy_(o)
    return _launch("decode_attention_fused", q, k, v, bias, kv_mask, heads,
                   scale, round_products=True, out=out)


# T5Config.decode_attention_impl -> the wrapper that computes its function
DECODE_ATTENTION_IMPLS = {
    "indicator": decode_attention_fused,
    "fused": decode_attention_fused,
    "pallas": decode_attention,
    "xla": decode_attention,
}


def decode_attention_for(impl: str):
    """The decode-step attention of ``T5Config.decode_attention_impl``."""
    try:
        return DECODE_ATTENTION_IMPLS[impl]
    except KeyError:
        raise ValueError(f"decode_attention_impl {impl!r} is not one of "
                         f"{sorted(DECODE_ATTENTION_IMPLS)}") from None
