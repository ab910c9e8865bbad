"""Analytic matmul-FLOP counts of the model's components.

Counterpart of ``multimodalpromptretrieval_tpu/ops/flops.py``, over the
port's ``T5Config`` / ``CLIPConfig``: the same functions and the same
integers. A matmul (m, k) @ (k, n) counts ``2*m*k*n`` operations, and only
matmuls are counted (norms, softmax, residuals and bias rows are
elementwise). These are the operation counts behind a component's least
time on the card (operations over the peak rate of their type).

Shapes follow the modules they model:
  * models/t5.py     encoder, teacher-forced decoder, greedy-decode step
    (fused qkv GEMM, row caches over the full T-token buffer each step)
  * models/clip.py   patchify-as-matmul ViT, causal text tower
  * ops/topk.py      the (B, N) L2 distance matmul
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig
    from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config


def _mm(m: int, k: int, n: int) -> int:
    """FLOPs of an (m,k)@(k,n) matmul under the 2*m*k*n convention."""
    return 2 * m * k * n


def _t5_ff_flops(cfg: "T5Config", rows: int) -> int:
    """One FF block over ``rows`` token rows (2 matmuls for relu T5 v1.0,
    3 for gated-gelu v1.1 — models/t5._ff_block)."""
    n_proj = 3 if cfg.feed_forward_proj == "gated-gelu" else 2
    return n_proj * _mm(rows, cfg.d_model, cfg.d_ff) if n_proj == 3 else (
        _mm(rows, cfg.d_model, cfg.d_ff) + _mm(rows, cfg.d_ff, cfg.d_model))


def t5_encoder_flops(cfg: "T5Config", B: int, L: int) -> int:
    """models/t5.t5_encode: per layer q/k/v/o projections, HxLxL
    attention, FF; the final RMSNorm is elementwise."""
    rows = B * L
    per_layer = (
        4 * _mm(rows, cfg.d_model, cfg.inner_dim)       # q, k, v, o
        + 2 * _mm(B * cfg.num_heads * L, cfg.d_kv, L)   # scores + att@V
        + _t5_ff_flops(cfg, rows)
    )
    return cfg.num_layers * per_layer


def t5_decoder_train_flops(cfg: "T5Config", B: int, T: int,
                           L_enc: int) -> int:
    """models/t5.t5_decode_train (teacher forcing): causal self-attn,
    cross-attn over the encoder states, FF; plus the LM head."""
    rows = B * T
    per_layer = (
        # self-attention: q/k/v/o + TxT attention
        4 * _mm(rows, cfg.d_model, cfg.inner_dim)
        + 2 * _mm(B * cfg.num_heads * T, cfg.d_kv, T)
        # cross-attention: q/k/v/o + TxL attention (k/v over L_enc rows)
        + 2 * _mm(rows, cfg.d_model, cfg.inner_dim)
        + 2 * _mm(B * L_enc, cfg.d_model, cfg.inner_dim)
        + 2 * _mm(B * cfg.num_heads * T, cfg.d_kv, L_enc)
        + _t5_ff_flops(cfg, rows)
    )
    return (cfg.num_decoder_layers * per_layer
            + _mm(rows, cfg.d_model, cfg.vocab_size))   # LM head


def t5_decode_prefill_flops(cfg: "T5Config", B: int, L_enc: int) -> int:
    """models/t5._precompute_cross_kv: per-layer cross k/v projections
    over the encoder states (done once per decode call)."""
    return cfg.num_decoder_layers * 2 * _mm(
        B * L_enc, cfg.d_model, cfg.inner_dim)


def t5_decode_step_flops(cfg: "T5Config", B: int, L_enc: int,
                         max_new_tokens: int) -> int:
    """ONE greedy-decode step (models/t5.t5_greedy_decode).

    The self-attention caches hold ``max_new_tokens`` rows and every step
    attends over the full (masked) buffer, so a step's FLOPs do not depend
    on the step. Per layer: the fused qkv GEMM, self
    attention over the T-token cache, cross q + attention over L_enc,
    the two o projections, FF; then the LM head on one token row.
    """
    T = max_new_tokens
    W = cfg.inner_dim
    per_layer = (
        _mm(B, cfg.d_model, 3 * W)            # fused q/k/v GEMM
        + 2 * _mm(B * cfg.num_heads, cfg.d_kv, T)     # self scores + @V
        + _mm(B, W, cfg.d_model)              # self o projection
        + _mm(B, cfg.d_model, W)              # cross q projection
        + 2 * _mm(B * cfg.num_heads, cfg.d_kv, L_enc)  # cross scores + @V
        + _mm(B, W, cfg.d_model)              # cross o projection
        + _t5_ff_flops(cfg, B)
    )
    return (cfg.num_decoder_layers * per_layer
            + _mm(B, cfg.d_model, cfg.vocab_size))     # LM head + argmax


def t5_greedy_decode_flops(cfg: "T5Config", B: int, L_enc: int,
                           max_new_tokens: int, executed_steps: int) -> int:
    """Prefill + ``executed_steps`` decode steps (``max_new_tokens`` when
    the loop does not stop early)."""
    return (t5_decode_prefill_flops(cfg, B, L_enc)
            + executed_steps * t5_decode_step_flops(cfg, B, L_enc,
                                                    max_new_tokens))


def vit_flops(cfg: "CLIPConfig", B: int) -> int:
    """models/clip.clip_image_tokens: patchify-as-matmul conv1, the
    pre-LN transformer over 1+grid^2 tokens, and the all-token output
    projection to the shared embedding space."""
    L = cfg.num_image_tokens
    w = cfg.vision_width
    flops = _mm(B * (L - 1), 3 * cfg.patch_size * cfg.patch_size, w)
    flops += _transformer_flops(B, L, w, cfg.vision_layers)
    flops += _mm(B * L, w, cfg.embed_dim)      # @proj, all tokens
    return flops


def clip_text_flops(cfg: "CLIPConfig", B: int, L: int) -> int:
    """models/clip.clip_encode_text at context length L (the serve path
    truncates to 32): causal transformer + EOT-row projection."""
    return (_transformer_flops(B, L, cfg.text_width, cfg.text_layers)
            + _mm(B, cfg.text_width, cfg.embed_dim))


def _transformer_flops(B: int, L: int, width: int, layers: int) -> int:
    """One CLIP residual block stack: q/k/v/o (head_dim*heads == width),
    LxL attention, 4x-MLP."""
    rows = B * L
    per_layer = (
        4 * _mm(rows, width, width)
        + 2 * _mm(B * L, width, L)             # scores + att@V (all heads)
        + _mm(rows, width, 4 * width) + _mm(rows, 4 * width, width)
    )
    return layers * per_layer


def l2_topk_flops(B: int, N: int, D: int) -> int:
    """ops/topk.l2_topk: the (B,D)@(D,N) distance matmul dominates."""
    return _mm(B, D, N)


def projection_flops(B: int, P: int, d_in: int, d_out: int) -> int:
    """The optional 512->1024 visual projection (t5-large leg)."""
    return _mm(B * P, d_in, d_out)
