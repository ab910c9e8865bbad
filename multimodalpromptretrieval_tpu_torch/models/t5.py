"""T5 encoder and greedy decode (serving path).

Counterpart of ``multimodalpromptretrieval_tpu/models/t5.py`` with the same
HF-parity numerics: RMS norm with fp32 reduction, UNSCALED attention logits
(scale 1.0: the 1/sqrt(d) is folded into T5's weights), relative position
bias (bidirectional in the encoder, causal in the decoder, none on
cross-attention), tied LM head with the d_model^-0.5 output scaling, greedy
decode from ``decoder_start_token_id`` that stops per row at EOS and pads
the rest.

The two JAX attention knobs pick the code path, as in the JAX package:

  * ``attention_impl`` (encoder): ``"row"`` runs (B*L, D) activations, the
    fused RMSNorm kernel and the packed row-attention kernel (K1) with the
    (H, L, L) position bias and the (B, L) key mask; ``"xla"`` runs the
    head-layout block of the JAX ``encoder_block`` (plain RMSNorm,
    ``attention_xla``); ``"pallas"``, ``"auto"`` and ``"pallas_interpret"``
    run the same block with the flash kernel (K8). Another name raises.
  * ``decode_attention_impl`` (greedy decode, row caches (B, T, W)):
    ``"indicator"`` (the default) and ``"fused"`` run K7, ``"pallas"`` and
    ``"xla"`` run K6 (``ops/decode_attention.py``): the four JAX names
    compute these two functions.

Layout: each attention's q/k/v projections are stored packed as one
``qkv`` weight (3 * inner, d_model), so the fused q/k/v GEMM needs no
per-call concatenation; q, k and v are its row blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.ops.attention import (
    multi_head_attention,
)
from multimodalpromptretrieval_tpu_torch.ops.decode_attention import (
    decode_attention_for,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    Linear,
    dense,
    gelu_new,
    param,
    rms_norm,
)
from multimodalpromptretrieval_tpu_torch.ops.norm import fused_rms_norm
from multimodalpromptretrieval_tpu_torch.ops.row_attention import (
    row_attention_packed,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" | "gated-gelu"
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    dropout_rate: float = 0.1
    # execution knobs, with the JAX names and defaults (module docstring).
    # decode_layers "unroll" and "scan" run one Python loop here (the JAX
    # package pins its two bit-equal, tests/test_t5_parity.py); remat is a
    # training knob and serving ignores it
    attention_impl: str = "xla"
    decode_attention_impl: str = "indicator"
    decode_layers: str = "unroll"
    remat: bool = False

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @staticmethod
    def t5_small() -> "T5Config":
        return T5Config()

    @staticmethod
    def t5_base() -> "T5Config":
        return T5Config(d_model=768, d_ff=3072, num_layers=12,
                        num_decoder_layers=12, num_heads=12)

    @staticmethod
    def t5_large() -> "T5Config":
        return T5Config(d_model=1024, d_ff=4096, num_layers=24,
                        num_decoder_layers=24, num_heads=16)

    @staticmethod
    def from_version(version: str) -> "T5Config":
        """Map the reference's ``T5_version`` config key to a config."""
        if "large" in version:
            return T5Config.t5_large()
        if "base" in version:
            return T5Config.t5_base()
        return T5Config.t5_small()


# ---------------------------------------------------------------------------
# Parameters (T5 'factor' init)
# ---------------------------------------------------------------------------


class T5Attention(nn.Module):
    """q/k/v packed into one (3 * inner, d_model) weight, and o."""

    def __init__(self, cfg: T5Config, generator: Optional[torch.Generator]):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim
        if generator is None:
            self.qkv = param((3 * inner, d), None)
        else:
            self.qkv = nn.Parameter(torch.cat([
                torch.randn((inner, d), generator=generator)
                * (d * cfg.d_kv) ** -0.5,
                torch.randn((2 * inner, d), generator=generator) * d ** -0.5,
            ]))
        self.o = Linear(inner, d, bias=False, std=inner ** -0.5,
                        generator=generator)


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, generator: Optional[torch.Generator]):
        super().__init__()
        s_in, s_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
        if cfg.feed_forward_proj == "gated-gelu":
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False, std=s_in,
                               generator=generator)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False, std=s_in,
                               generator=generator)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False, std=s_in,
                             generator=generator)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, std=s_out,
                         generator=generator)


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.attn = T5Attention(cfg, generator)
        self.attn_ln = param((cfg.d_model,), generator, fill=1.0)
        self.ff = T5FF(cfg, generator)
        self.ff_ln = param((cfg.d_model,), generator, fill=1.0)


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, generator: Optional[torch.Generator]):
        super().__init__()
        self.self_attn = T5Attention(cfg, generator)
        self.self_ln = param((cfg.d_model,), generator, fill=1.0)
        self.cross_attn = T5Attention(cfg, generator)
        self.cross_ln = param((cfg.d_model,), generator, fill=1.0)
        self.ff = T5FF(cfg, generator)
        self.ff_ln = param((cfg.d_model,), generator, fill=1.0)


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, layer, n_layers: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.block = nn.ModuleList(layer(cfg, generator)
                                   for _ in range(n_layers))
        self.rel_bias = param(
            (cfg.relative_attention_num_buckets, cfg.num_heads), generator,
            std=cfg.inner_dim ** -0.5)
        self.final_ln = param((cfg.d_model,), generator, fill=1.0)


class T5(nn.Module):
    """Shared embedding + encoder + decoder stacks. ``generator`` draws the
    seeded random init; ``None`` leaves the parameters to be loaded."""

    def __init__(self, cfg: T5Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.shared = param((cfg.vocab_size, cfg.d_model), generator,
                            std=1.0)
        self.encoder = T5Stack(cfg, T5EncoderLayer, cfg.num_layers,
                               generator)
        self.decoder = T5Stack(cfg, T5DecoderLayer, cfg.num_decoder_layers,
                               generator)


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------


def relative_position_bucket(relative_position: torch.Tensor, *,
                             bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5's bucketing. relative_position = key_pos - query_pos."""
    rel = relative_position
    bucket = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (rel > 0).to(rel.dtype) * num_buckets
        rel = torch.abs(rel)
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_f = torch.clamp(rel.float(), min=1.0)
    large = max_exact + (
        torch.log(rel_f / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return bucket + torch.where(is_small, rel, large)


@functools.lru_cache(maxsize=64)
def _buckets(q_len: int, k_len: int, bidirectional: bool, num_buckets: int,
             max_distance: int) -> torch.Tensor:
    """Bucket ids (q_len, k_len), computed once per shape on the host so
    that every device reads the same table."""
    ctx = torch.arange(q_len, dtype=torch.int32)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32)[None, :]
    return relative_position_bucket(
        mem - ctx, bidirectional=bidirectional, num_buckets=num_buckets,
        max_distance=max_distance).long()


def compute_position_bias(rel_bias_table: torch.Tensor, q_len: int,
                          k_len: int, *, bidirectional: bool,
                          cfg: T5Config) -> torch.Tensor:
    """(1, H, q_len, k_len) additive bias."""
    buckets = _buckets(q_len, k_len, bidirectional,
                       cfg.relative_attention_num_buckets,
                       cfg.relative_attention_max_distance)
    bias = rel_bias_table[buckets.to(rel_bias_table.device)]  # (q, k, H)
    return bias.permute(2, 0, 1)[None]


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _ff_block(p: T5FF, cfg: T5Config, x: torch.Tensor) -> torch.Tensor:
    if cfg.feed_forward_proj == "gated-gelu":
        h = gelu_new(p.wi_0(x)) * p.wi_1(x)
    else:
        h = torch.relu(p.wi(x))
    return p.wo(h)


def _attention_block(p: T5Attention, cfg: T5Config, x: torch.Tensor, *,
                     bias: torch.Tensor,
                     kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """JAX ``_attention_block`` (self-attention): the fused q/k/v GEMM, its
    (B, H, L, Dh) head views (no copies), ``multi_head_attention`` under
    ``cfg.attention_impl`` with scale 1.0, the o projection."""
    B, L, _ = x.shape
    H, Dh = cfg.num_heads, cfg.d_kv
    qkv = dense(x, p.qkv).view(B, L, 3, H, Dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = multi_head_attention(q, k, v, bias=bias, kv_mask=kv_mask,
                             causal=False, scale=1.0,
                             impl=cfg.attention_impl)
    return p.o(o.transpose(1, 2).reshape(B, L, H * Dh))


def encoder_block(p: T5EncoderLayer, cfg: T5Config, x: torch.Tensor, *,
                  bias: torch.Tensor,
                  kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One encoder block of the head-layout path (JAX ``encoder_block``):
    pre-norm self-attention and FF with residuals, over (B, L, D)."""
    eps = cfg.layer_norm_epsilon
    h = rms_norm(x, p.attn_ln, eps)
    x = x + _attention_block(p.attn, cfg, h, bias=bias, kv_mask=kv_mask)
    h = rms_norm(x, p.ff_ln, eps)
    return x + _ff_block(p.ff, cfg, h)


def t5_encode(params: T5, cfg: T5Config, inputs_embeds: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder stack over input embeddings (B, L, D); attention_mask (B, L)
    in {0, 1}. Inference only (no dropout). ``cfg.attention_impl`` picks
    the row path or the head-layout path (module docstring)."""
    enc = params.encoder
    B, L, D = inputs_embeds.shape
    W = cfg.inner_dim
    eps = cfg.layer_norm_epsilon
    bias = compute_position_bias(enc.rel_bias, L, L, bidirectional=True,
                                 cfg=cfg)  # (1, H, L, L)
    if cfg.attention_impl != "row":
        x = inputs_embeds
        for p in enc.block:
            x = encoder_block(p, cfg, x, bias=bias, kv_mask=attention_mask)
        return rms_norm(x, enc.final_ln, eps)
    x = inputs_embeds.reshape(B * L, D)
    for p in enc.block:
        h = fused_rms_norm(x, p.attn_ln, eps)
        qkv = dense(h, p.attn.qkv).reshape(B, L, 3 * W)
        o = row_attention_packed(qkv, bias[0], attention_mask,
                                 heads=cfg.num_heads, scale=1.0)
        x = x + p.attn.o(o.reshape(B * L, W))
        h = fused_rms_norm(x, p.ff_ln, eps)
        x = x + _ff_block(p.ff, cfg, h)
    x = fused_rms_norm(x, enc.final_ln, eps)
    return x.reshape(B, L, D)


# ---------------------------------------------------------------------------
# Greedy decode over row caches
# ---------------------------------------------------------------------------


def _precompute_cross_kv(params: T5, cfg: T5Config,
                         encoder_hidden: torch.Tensor
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Cross-attention K/V depend only on the encoder output: once per
    call, per layer, as (B, Lk, W) rows."""
    W = cfg.inner_dim
    return [(dense(encoder_hidden, p.cross_attn.qkv[W:2 * W]),
             dense(encoder_hidden, p.cross_attn.qkv[2 * W:]))
            for p in params.decoder.block]


@torch.no_grad()
def t5_greedy_decode(params: T5, cfg: T5Config,
                     encoder_hidden: torch.Tensor,
                     encoder_mask: Optional[torch.Tensor],
                     max_new_tokens: int = 20,
                     early_stop: bool = True) -> torch.Tensor:
    """Greedy generation: (B, 1 + max_new_tokens) int32 sequences starting
    with decoder_start_token_id; positions after EOS are pad.

    Matches HF ``generate(do_sample=False, max_new_tokens=N)``. The JAX
    ``lax.while_loop`` becomes this Python loop; the self-attention caches
    are this call's own (B, T, W) buffers, updated in place. Both
    ``decode_layers`` settings run this one loop over the layers: the JAX
    package's "unroll" and "scan" are the same math, pinned bit-equal by
    its tests. ``cfg.decode_attention_impl`` picks K6 or K7 for every
    self- and cross-attention of the loop."""
    attend = decode_attention_for(cfg.decode_attention_impl)
    dec = params.decoder
    B = encoder_hidden.shape[0]
    H, W, T = cfg.num_heads, cfg.inner_dim, max_new_tokens
    eps = cfg.layer_norm_epsilon
    dev, dt = encoder_hidden.device, encoder_hidden.dtype
    cross = _precompute_cross_kv(params, cfg, encoder_hidden)
    enc_kv_mask = (None if encoder_mask is None
                   else encoder_mask.to(torch.int32))
    # the causal decoder position bias, keys after the step masked out of
    # it (in its own dtype, as JAX masks it), made once as fp32 (T, H, T):
    # step t reads the contiguous (H, T) row step_bias[t]
    full_bias = compute_position_bias(dec.rel_bias, T, T,
                                      bidirectional=False, cfg=cfg)[0]
    key_pos = torch.arange(T, device=dev)
    future = key_pos[None, :] > key_pos[:, None]  # [t, j]: key j after t
    step_bias = (full_bias.masked_fill(future[None], -1e9).float()
                 .transpose(0, 1).contiguous())
    self_k = [torch.zeros((B, T, W), dtype=dt, device=dev)
              for _ in dec.block]
    self_v = [torch.zeros_like(c) for c in self_k]
    tokens = torch.full((B, T + 1), cfg.pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)

    for t in range(T):
        x = params.shared[tokens[:, t].long()]  # (B, D)
        for li, p in enumerate(dec.block):
            h = rms_norm(x, p.self_ln, eps)
            qkv = dense(h, p.self_attn.qkv)  # (B, 3W)
            self_k[li][:, t] = qkv[:, W:2 * W]
            self_v[li][:, t] = qkv[:, 2 * W:]
            o = attend(qkv[:, :W], self_k[li], self_v[li],
                       bias=step_bias[t], heads=H)
            x = x + p.self_attn.o(o)

            h = rms_norm(x, p.cross_ln, eps)
            q = dense(h, p.cross_attn.qkv[:W])
            o = attend(q, *cross[li], kv_mask=enc_kv_mask, heads=H)
            x = x + p.cross_attn.o(o)

            h = rms_norm(x, p.ff_ln, eps)
            x = x + _ff_block(p.ff, cfg, h)
        x = rms_norm(x, dec.final_ln, eps)
        x = x * (cfg.d_model ** -0.5)
        logits = dense(x, params.shared.to(x.dtype))
        # argmax on the compute-dtype logits, first maximum on ties
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        next_tok = torch.where(finished, cfg.pad_token_id, next_tok)
        finished = finished | (next_tok == cfg.eos_token_id)
        tokens[:, t + 1] = next_tok
        # Early exit is checked on the host after EVERY step: one device
        # sync per step. How often to sync is a later, measured choice
        # (ROADMAP A5).
        if early_stop and bool(finished.all()):
            break
    return tokens
