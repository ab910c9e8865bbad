"""Multi-head attention over (B, H, L, Dh), and flash attention (kernel K8).

Counterpart of ``multimodalpromptretrieval_tpu/ops/attention.py``, same API
and layout. ``multi_head_attention`` picks one of two functions, which agree
at fp32 and round differently at bf16:

  * ``"xla"`` -> :func:`attention_xla`: scores produced in the compute dtype
    (fp32 accumulation, one rounding) then cast to fp32, exact fp32 softmax,
    probabilities rounded to the compute dtype before P.V;
  * ``"pallas"``, ``"auto"``, ``"pallas_interpret"`` -> :func:`flash_attention`
    (K8), the JAX Pallas flash kernel's function: fp32 scores, and an online
    softmax over the kernel's key blocks in which the UNNORMALISED
    ``exp(s - running max)`` is rounded to the value dtype per block and the
    fp32 sum divides at the end.

Both take an additive bias broadcast over (B, H) (shapes (B, H), (1, H),
(B, 1), (1, 1) in front of (Lq, Lk)), a (B, Lk) key mask whose zeros
replace the score with -1e9, and ``causal``. -1e9, not -inf: a fully masked
row stays finite. An unknown ``impl`` raises (the JAX package falls through
to XLA silently).

``flash_attention`` dispatches on the device only: a CPU tensor takes
:func:`flash_attention_reference`, which replays the JAX kernel block by
block (differentiable by autograd); a CUDA tensor launches
``csrc/flash_attention.cu`` or raises. On the card, inputs that require
grad go through one ``torch.autograd.Function``: the kernel forward, and
the standard attention backward in plain torch with the scores recomputed
(:func:`_flash_bwd`, the rounding points of ``ops/row_attention._row_bwd``:
the JAX kernel defines no gradient of its own), so that the pipeline's
stages train under ``attention_impl="pallas"``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_NEG_INF = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel is instantiated for the towers' one head dim (ViT-B/32, the
# CLIP text tower and every T5 size)
_HEAD_DIMS = (64,)
FLASH_IMPLS = ("pallas", "auto", "pallas_interpret")


def attention_xla(q, k, v, bias=None, kv_mask=None, causal=False,
                  scale=1.0):
    """JAX ``_attention_xla``: the scores are rounded to the compute dtype
    (the einsum's output) before the fp32 softmax."""
    Lq, Lk = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.to(q.dtype).transpose(-1, -2)).float()
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + bias.float()
    if kv_mask is not None:
        s = s.masked_fill(kv_mask[:, None, None, :] == 0, _NEG_INF)
    if causal:
        pos_q = torch.arange(Lq, device=q.device)
        pos_k = torch.arange(Lk, device=q.device)
        s = s.masked_fill(pos_k[None, :] > pos_q[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_blocks(Lq: int, Lk: int, block_q: int = 512,
                 block_k: int = 1024) -> Tuple[int, int]:
    """The JAX kernel's block clamps (``_flash_attention``): short
    sequences shrink the blocks to a power of two, at least 8 query rows
    and 128 keys."""
    return (min(block_q, max(8, 1 << (Lq - 1).bit_length())),
            min(block_k, max(128, 1 << (Lk - 1).bit_length())))


def _bias_rows(bias: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """A bias that broadcasts over (B, H) the way the JAX kernel maps it:
    batch row b reads bias row b % bB, head h reads head h % bH."""
    bB, bH = bias.shape[:2]
    if bB not in (1, B):
        bias = bias[torch.arange(B, device=bias.device) % bB]
    if bH not in (1, H):
        bias = bias[:, torch.arange(H, device=bias.device) % bH]
    return bias


def flash_attention_reference(q, k, v, bias=None, kv_mask=None, *,
                              causal: bool = False, scale: float = 1.0,
                              block_q: int = 512,
                              block_k: int = 1024) -> torch.Tensor:
    """Plain version of K8: JAX ``_flash_attention`` replayed per key block.

    Keys are padded to a multiple of the clamped ``block_k`` (tail keys
    masked by ``col < Lk``, their values zero). Per block: fp32 scores,
    scale, bias, ``where``-masking with -1e9, the running max ``m``,
    ``alpha = exp(m_prev - m_new)``, the running fp32 sum ``l`` of the
    unrounded ``p = exp(s - m_new)``, and ``acc = acc * alpha + p @ v`` with
    ``p`` rounded to the value dtype. With ``causal``, a key block that lies
    wholly after a query block (at the JAX block granularity) is skipped
    for that block's rows, as the kernel skips it. Output ``acc / l``.
    Query rows are independent, so they are not padded.
    """
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    bq, bk = flash_blocks(Lq, Lk, block_q, block_k)
    nk = -(-Lk // bk)
    pad = nk * bk - Lk
    dev = q.device
    qf = q.float()
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v, (0, 0, 0, pad)).float()
    col = torch.arange(nk * bk, device=dev)
    valid = (col < Lk)[None, None, None, :]
    if kv_mask is not None:
        mask = torch.nn.functional.pad(kv_mask.to(torch.int32), (0, pad))
        valid = valid & (mask[:, None, None, :] != 0)
    if bias is not None:
        bias = torch.nn.functional.pad(_bias_rows(bias, B, H).float(),
                                       (0, pad))
    row = torch.arange(Lq, device=dev)
    m = torch.full((B, H, Lq, 1), _NEG_INF, device=dev)
    l = torch.zeros((B, H, Lq, 1), device=dev)
    acc = torch.zeros((B, H, Lq, Dh), device=dev)
    for ik in range(nk):
        cs = slice(ik * bk, (ik + 1) * bk)
        s = torch.matmul(qf, kf[:, :, cs].transpose(-1, -2))
        if scale != 1.0:
            s = s * scale
        if bias is not None:
            s = s + bias[..., cs]
        ok = valid[..., cs]
        if causal:
            ok = ok & (col[cs][None, :] <= row[:, None])
        s = torch.where(ok, s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                             vf[:, :, cs])
        if causal:
            live = (ik * bk <= (row // bq) * bq + bq - 1)[:, None]
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l)
            acc_new = torch.where(live, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    return (acc / l).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, scale: float = 1.0,
                    block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """K8. q (B, H, Lq, Dh), k / v (B, H, Lk, Dh), each with any batch,
    head and row strides and a unit last stride; bias (bB, bH, Lq, Lk);
    kv_mask (B, Lk). Returns (B, H, Lq, Dh): on the card a view of a
    (B, Lq, H, Dh) buffer, so that the caller's head merge is free.
    Differentiable in q, k, v and ``bias``."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, bias, kv_mask, causal=causal, scale=scale,
            block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias, kv_mask, causal, scale,
                                     block_q, block_k)
    return _flash_launch(q, k, v, bias, kv_mask, causal, scale, block_q,
                         block_k)


def _flash_launch(q, k, v, bias, kv_mask, causal: bool, scale: float,
                  block_q: int, block_k: int) -> torch.Tensor:
    """Check the inputs and launch K8, counted."""
    name = "flash_attention"
    _build.require_cuda(name, q, k, v, *(t for t in (bias, kv_mask)
                                         if t is not None))
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                        "are not one of float32, bfloat16")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {Dh} not in {_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: q / k / v need a unit last stride")
    if B * H >= 2 ** 31:
        raise ValueError(f"{name}: B * H = {B * H} does not fit the grid")
    bq, bk = flash_blocks(Lq, Lk, block_q, block_k)
    lib = _build.library()
    max_cols = lib.mpr_flash_attention_max_cols(Dh)
    if min(bk, Lk) > max_cols:
        raise ValueError(f"{name}: key block {min(bk, Lk)} exceeds the "
                         f"shared-memory score block ({max_cols})")
    bias32 = mask32 = None
    bB = bH = 1
    if bias is not None:
        if bias.dim() != 4 or tuple(bias.shape[2:]) != (Lq, Lk):
            raise ValueError(f"{name}: bias {tuple(bias.shape)} is not "
                             f"(bB, bH, {Lq}, {Lk})")
        bB, bH = bias.shape[:2]
        bias32 = bias.to(torch.float32).contiguous()
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Lk):
            raise ValueError(f"{name}: kv_mask {tuple(kv_mask.shape)} is "
                             f"not {(B, Lk)}")
        mask32 = kv_mask.to(torch.int32).contiguous()
    out = torch.empty((B, Lq, H, Dh), dtype=q.dtype, device=q.device)
    code = lib.mpr_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3],
        None if bias32 is None else bias32.data_ptr(), bB, bH,
        None if mask32 is None else mask32.data_ptr(), out.data_ptr(),
        B, H, Lq, Lk, Dh, float(scale), int(causal), bq, bk,
        _DTYPE_CODES[q.dtype], _build.stream_handle(q))
    _build.check(code, name)
    _build.count_launch(name)
    return out.transpose(1, 2)


def _flash_bwd(q, k, v, bias, kv_mask, causal: bool, scale: float, g):
    """The standard attention backward over (B, H, L, Dh), the scores
    recomputed: products in the input dtype cast to fp32, the forward's
    -1e9 masking, an fp32 softmax; ``p`` cast to the cotangent's dtype for
    ``dv``, ``ds * scale`` to q's dtype for ``dq`` / ``dk``; ``d_bias``
    the fp32 ``ds`` summed over the dimensions the bias broadcasts along,
    cast to its dtype. Returns (dq, dk, dv, d_bias or None)."""
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)).float()
    if scale != 1.0:
        s = s * scale
    if bias is not None:
        s = s + _bias_rows(bias, B, H).float()
    ok = torch.ones((1, 1, Lq, Lk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        ok = ok & (kv_mask[:, None, None, :] != 0)
    if causal:
        pos_q = torch.arange(Lq, device=q.device)
        pos_k = torch.arange(Lk, device=q.device)
        ok = ok & (pos_k[None, :] <= pos_q[:, None])
    p = torch.softmax(torch.where(ok, s, _NEG_INF), dim=-1)
    dv = torch.matmul(p.to(g.dtype).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2)).float()
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    d_bias = None
    if bias is not None:
        dims = [d for d in (0, 1) if bias.shape[d] == 1 and ds.shape[d] > 1]
        d_bias = (ds.sum(dim=dims, keepdim=True) if dims else ds).to(
            bias.dtype)
    ds_scaled = (ds * scale).to(q.dtype)
    return (torch.matmul(ds_scaled, k), torch.matmul(
        ds_scaled.transpose(-1, -2), q), dv, d_bias)


class _FlashAttention(torch.autograd.Function):
    """Forward: K8. Backward: the recompute of :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, causal, scale, block_q,
                block_k):
        if bias is not None and any(
                n not in (1, m) for n, m in zip(bias.shape[:2], q.shape)):
            raise ValueError("flash_attention: a bias that repeats over "
                             f"(B, H) {tuple(bias.shape[:2])} has no "
                             "gradient here")
        ctx.save_for_backward(q, k, v, bias, kv_mask)
        ctx.cfg = (causal, scale)
        return _flash_launch(q, k, v, bias, kv_mask, causal, scale, block_q,
                             block_k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, bias, kv_mask = ctx.saved_tensors
        dq, dk, dv, d_bias = _flash_bwd(q, k, v, bias, kv_mask, *ctx.cfg, g)
        return dq, dk, dv, d_bias, None, None, None, None, None


def multi_head_attention(q, k, v, *, bias=None, kv_mask=None, causal=False,
                         scale=None, impl: str = "auto"):
    """Multi-head attention over (B, H, L, Dh). ``scale`` defaults to
    1/sqrt(Dh) (T5 passes 1.0). ``impl``: ``"xla"`` -> :func:`attention_xla`;
    ``"pallas"`` / ``"auto"`` / ``"pallas_interpret"`` -> :func:`flash_attention`
    (K8)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "xla":
        return attention_xla(q, k, v, bias, kv_mask, causal, scale)
    if impl in FLASH_IMPLS:
        return flash_attention(q, k, v, bias, kv_mask, causal=causal,
                               scale=scale)
    raise ValueError(f"attention impl {impl!r} is not one of "
                     f"{('xla',) + FLASH_IMPLS}")
