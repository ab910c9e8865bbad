"""Absorbed latent decode attention (MLA) of the LM generator
(``models/moe_lm.py``).

Replaces no TPU kernel: the JAX package has no latent attention. The port
added it for the Kimi-VL-A3B language model, whose DeepSeek-V3 attention
caches one 576-wide row a token and layer (the normed latent ``c``, 512,
then the roped shared key part ``k_pe``, 64) instead of per-head K and V.
With ``W_UK`` absorbed into the query (``q_lat = q_nope W_UK``, 512 a
head) and ``W_UV`` applied after, a decode step's attention is, per head h
of a row,

    s_j = (q_lat[h] . c_j + q_pe[h] . k_pe_j) * scale
    o[h] = softmax_j(s_j over the row's valid keys) . c_j     (512 wide)

so all 16 heads share one key and one value row a token. K6 / K7 (per-head
K / V at head width 64) cannot take it.

:func:`mla_decode_attention` dispatches on the device: a CPU tensor takes
:func:`mla_decode_attention_reference`, a CUDA tensor K11, the CUDA C++
kernel of ``csrc/mla_decode.cu``, or raises.

What bounds it on the H100: the cache. A step reads each row's T x 576
values once (bf16: 1,152 bytes a token), and does 2 x (576 + 512) x 16
operations a token: ~30 operations a byte, far below the card's ~295, so
bytes. Design: a block a (row, 16 heads), so a row's cache is read once
for all its heads and the heads are the M of the tensor-core product; the
cache streams through in tiles of 32 tokens, both products on the tensor
cores, an online softmax in fp32, the (16, 512) output accumulated in fp32
(``csrc/mla_decode.cu`` says how).
"""

from __future__ import annotations

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
# fp32 holds the query and every key's score in a block's 48 KB
_F32_MAX = 12288


def mla_decode_attention_reference(q_lat: torch.Tensor, q_pe: torch.Tensor,
                                   cache: torch.Tensor, key_ok: torch.Tensor,
                                   length: int, scale: float) -> torch.Tensor:
    """The plain version. ``q_lat`` (B, H, C), ``q_pe`` (B, H, R),
    ``cache`` (B, T_max, C + R), ``key_ok`` (B, T_max) (nonzero: a valid
    key), keys ``[0, length)``: (B, H, C) in ``q_lat``'s dtype, fp32
    inside."""
    C = q_lat.shape[-1]
    kv = cache[:, :length].float()
    s = (torch.matmul(q_lat.float(), kv[..., :C].transpose(1, 2))
         + torch.matmul(q_pe.float(), kv[..., C:].transpose(1, 2))) * scale
    s = s.masked_fill(~key_ok[:, None, :length].bool(), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, kv[..., :C]).to(q_lat.dtype)


def _check(q_lat, q_pe, cache, key_ok, length):
    _build.require_cuda("mla_decode_attention", q_lat, q_pe, cache, key_ok)
    B, H, C = q_lat.shape
    R = q_pe.shape[-1]
    if q_lat.dtype not in _DTYPES:
        raise TypeError(f"mla_decode_attention: dtype {q_lat.dtype}")
    if q_pe.dtype != q_lat.dtype or cache.dtype != q_lat.dtype:
        raise TypeError("mla_decode_attention: q_lat, q_pe and cache "
                        "differ in dtype")
    if (tuple(q_pe.shape[:2]) != (B, H) or cache.shape[0] != B
            or cache.shape[-1] != C + R or tuple(key_ok.shape) != (
                B, cache.shape[1])):
        raise ValueError(
            f"mla_decode_attention: q_lat {tuple(q_lat.shape)}, q_pe "
            f"{tuple(q_pe.shape)}, cache {tuple(cache.shape)}, key_ok "
            f"{tuple(key_ok.shape)}")
    if not 0 < length <= cache.shape[1]:
        raise ValueError(f"mla_decode_attention: length {length} outside "
                         f"(0, {cache.shape[1]}]")
    if cache.stride(-1) != 1 or q_lat.stride(-1) != 1 or q_pe.stride(-1) != 1:
        raise ValueError("mla_decode_attention: the last dimensions must be "
                         "contiguous")
    if q_lat.dtype == torch.float32:
        if C + R + length > _F32_MAX:
            raise ValueError(f"mla_decode_attention: fp32 takes C + R + "
                             f"length <= {_F32_MAX}, got {C + R + length}")
        return
    if C != 512 or R % 32:
        raise ValueError("mla_decode_attention: bf16 takes a latent width of "
                         f"512 and a rope width a multiple of 32, got {C} "
                         f"and {R}")
    if any(t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1])
           for t in (q_lat, q_pe, cache)):
        raise ValueError("mla_decode_attention: bf16 rows must start on 16 "
                         "bytes (bases and strides)")


def mla_decode_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                         cache: torch.Tensor, key_ok: torch.Tensor,
                         length: int, scale: float) -> torch.Tensor:
    """Absorbed latent attention of one decode step (module docstring);
    the arguments of :func:`mla_decode_attention_reference`."""
    if q_lat.device.type == "cpu":
        return mla_decode_attention_reference(q_lat, q_pe, cache, key_ok,
                                              length, scale)
    _check(q_lat, q_pe, cache, key_ok, length)
    if key_ok.dtype != torch.int8:
        key_ok = key_ok.to(torch.int8)
    key_ok = key_ok.contiguous()
    B, H, C = q_lat.shape
    R = q_pe.shape[-1]
    out = torch.empty((B, H, C), dtype=q_lat.dtype, device=q_lat.device)
    lib = _build.library()
    _build.check(lib.mpr_mla_decode_attention(
        q_lat.data_ptr(), q_pe.data_ptr(), cache.data_ptr(),
        key_ok.data_ptr(), out.data_ptr(), q_lat.stride(0), q_lat.stride(1),
        q_pe.stride(0), q_pe.stride(1), cache.stride(0), cache.stride(1),
        key_ok.stride(0), B, H, C, R, int(length), float(scale),
        0 if q_lat.dtype == torch.float32 else 1,
        _build.stream_handle(q_lat)), "mpr_mla_decode_attention")
    _build.count_launch("mla_decode_attention")
    return out
