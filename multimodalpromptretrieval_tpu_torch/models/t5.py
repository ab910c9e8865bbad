"""T5 encoder, teacher-forced decoder and loss, and greedy decode.

Counterpart of ``multimodalpromptretrieval_tpu/models/t5.py`` with the same
HF-parity numerics: RMS norm with fp32 reduction, UNSCALED attention logits
(scale 1.0: the 1/sqrt(d) is folded into T5's weights), relative position
bias (bidirectional in the encoder, causal in the decoder, none on
cross-attention), tied LM head with the d_model^-0.5 output scaling, greedy
decode from ``decoder_start_token_id`` that stops per row at EOS and pads
the rest. Training adds HF-style dropout at the JAX points (input
embeddings, each sublayer output before the residual add, the FF hidden
after the activation, the final hidden state), drawn from one explicit
``torch.Generator``; ``None`` is evaluation. ``cfg.remat`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``).

Tensor parallelism (``tp``, the "model" axis of ``parallel/mesh.py``): the
blocks, the row layer of :func:`t5_encode` and :func:`t5_greedy_decode`
take the axis and run Megatron TP on the rank's shards of the block
weights (``parallel/mesh.param_spec``). The local head count comes from
the ``qkv`` weight's rows, as the JAX ``_attention_block`` reads it from
its kernel; the position bias keeps the rank's heads' rows (a table split
over heads already yields them); ``copy_to_model`` enters and
``reduce_from_model`` leaves each attention and FF sub-block, so the
residual stream stays whole on every rank. The FF hidden's dropout keeps
the rank's ``d_ff`` columns of the mask one process draws
(``ops.layers.column_block``). Without ``tp`` nothing changes.

The two JAX attention knobs pick the code path, as in the JAX package:

  * ``attention_impl`` (encoder): ``"row"`` runs (B*L, D) activations, the
    fused RMSNorm kernel and the packed row-attention kernel (K1) with the
    (H, L, L) position bias and the (B, L) key mask; ``"xla"`` runs the
    head-layout block of the JAX ``encoder_block`` (plain RMSNorm,
    ``attention_xla``); ``"pallas"``, ``"auto"`` and ``"pallas_interpret"``
    run the same block with the flash kernel (K8). Another name raises. The
    teacher-forced decoder has no row path in the JAX package: under
    ``"row"`` it runs ``attention_xla`` and the plain RMSNorm, as there.
  * ``decode_attention_impl`` (greedy decode, row caches (B, T, W)):
    ``"indicator"`` (the default) and ``"fused"`` run K7, ``"pallas"`` and
    ``"xla"`` run K6 (``ops/decode_attention.py``): the four JAX names
    compute these two functions. The speculative decode's verification
    pass runs ``block_attention_indicator``, or the head-layout
    ``attention_xla`` under ``"xla"``, as in the JAX package.

Layout: each attention's q/k/v projections are stored packed as one
``qkv`` weight (3 * inner, d_model), so the fused q/k/v GEMM needs no
per-call concatenation; q, k and v are its row blocks.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from multimodalpromptretrieval_tpu_torch.models import greedy
from multimodalpromptretrieval_tpu_torch.ops.attention import (
    multi_head_attention,
)
from multimodalpromptretrieval_tpu_torch.ops.decode_attention import (
    block_attention_indicator,
    decode_attention_for,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    Linear,
    dense,
    column_block,
    dropout,
    gelu_new,
    param,
    rms_norm,
)
from multimodalpromptretrieval_tpu_torch.ops.norm import fused_rms_norm
from multimodalpromptretrieval_tpu_torch.ops.row_attention import (
    row_attention_packed,
)
from multimodalpromptretrieval_tpu_torch.parallel.mesh import (
    copy_to_model,
    reduce_from_model,
)
from multimodalpromptretrieval_tpu_torch.train import profiling


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
    # package pins its two bit-equal, tests/test_t5_parity.py); remat
    # recomputes each layer in the backward pass of training
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
    that every device reads the same table. Made outside inference mode:
    the cache outlives the call, and an inference tensor first made by a
    server would refuse a later training step's autograd."""
    with torch.inference_mode(False):
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


def _rows(w) -> int:
    """Output rows of a weight (a tensor or an int8 ``QWeight``)."""
    return (w if isinstance(w, torch.Tensor) else w.q8).shape[0]


def local_heads(p: T5Attention, cfg: T5Config) -> int:
    """The heads of ``p``'s packed ``qkv`` (all of them, or a tensor-
    parallel rank's)."""
    return _rows(p.qkv) // (3 * cfg.d_kv)


def head_rows(bias: torch.Tensor, heads: int, tp, dim: int) -> torch.Tensor:
    """The rank's ``heads`` rows of a position bias along ``dim`` (the
    bias itself when it has no more)."""
    if tp is None or bias.shape[dim] == heads:
        return bias
    return bias.narrow(dim, tp.index * heads, heads)


def _ff_block(p: T5FF, cfg: T5Config, x: torch.Tensor,
              gen: Optional[torch.Generator] = None,
              tp=None) -> torch.Tensor:
    x = copy_to_model(x, tp)
    if cfg.feed_forward_proj == "gated-gelu":
        h = gelu_new(p.wi_0(x)) * p.wi_1(x)
    else:
        h = torch.relu(p.wi(x))
    # HF T5DenseActDense: dropout after the activation
    if tp is not None:
        gen = column_block(gen, tp.index, tp.size)
    return reduce_from_model(p.wo(dropout(h, cfg.dropout_rate, gen)), tp)


def _attention_block(p: T5Attention, cfg: T5Config, x_q: torch.Tensor,
                     x_kv: Optional[torch.Tensor] = None, *,
                     bias: Optional[torch.Tensor],
                     kv_mask: Optional[torch.Tensor],
                     causal: bool = False,
                     impl: Optional[str] = None, tp=None,
                     attention: Optional[Callable] = None) -> torch.Tensor:
    """JAX ``_attention_block``: q from ``x_q`` and k, v from ``x_kv``
    (``None``: self-attention, one fused q/k/v GEMM), their (B, H, L, Dh)
    head views (no copies), ``multi_head_attention`` under ``impl``
    (default ``cfg.attention_impl``) with scale 1.0, the o projection.
    Under ``tp`` on the rank's heads, with the bias's rows of them.
    ``attention(q, k, v)`` takes the place of ``multi_head_attention``
    (the sequence-parallel ring, which holds its own bias and mask)."""
    B, Lq, _ = x_q.shape
    Dh = cfg.d_kv
    H = local_heads(p, cfg)
    W = H * Dh
    x_q = copy_to_model(x_q, tp)
    if x_kv is not None:
        x_kv = copy_to_model(x_kv, tp)
    if bias is not None:
        bias = head_rows(bias, H, tp, 1)
    if x_kv is None:
        qkv = dense(x_q, p.qkv).view(B, Lq, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q = dense(x_q, p.qkv[:W]).view(B, Lq, H, Dh).transpose(1, 2)
        kv = dense(x_kv, p.qkv[W:]).view(B, x_kv.shape[1], 2, H, Dh)
        k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
    if attention is not None:
        o = attention(q, k, v)
    else:
        o = multi_head_attention(q, k, v, bias=bias, kv_mask=kv_mask,
                                 causal=causal, scale=1.0,
                                 impl=impl or cfg.attention_impl)
    return reduce_from_model(p.o(o.transpose(1, 2).reshape(B, Lq, W)), tp)


def encoder_block(p: T5EncoderLayer, cfg: T5Config, x: torch.Tensor, *,
                  bias: torch.Tensor, kv_mask: Optional[torch.Tensor],
                  gen: Optional[torch.Generator] = None,
                  tp=None, attention: Optional[Callable] = None
                  ) -> torch.Tensor:
    """One encoder block of the head-layout path (JAX ``encoder_block``):
    pre-norm self-attention and FF with residuals, over (B, L, D).
    ``attention_impl="row"`` runs ``attention_xla`` here (the pipeline's
    stages call this block), as in the JAX package, whose
    ``multi_head_attention`` has no row branch. ``attention``: as
    :func:`_attention_block` takes it."""
    eps, rate = cfg.layer_norm_epsilon, cfg.dropout_rate
    impl = "xla" if cfg.attention_impl == "row" else cfg.attention_impl
    h = rms_norm(x, p.attn_ln, eps)
    x = x + dropout(_attention_block(p.attn, cfg, h, bias=bias,
                                     kv_mask=kv_mask, impl=impl, tp=tp,
                                     attention=attention),
                    rate, gen)
    h = rms_norm(x, p.ff_ln, eps)
    return x + dropout(_ff_block(p.ff, cfg, h, gen, tp), rate, gen)


def decoder_block(p: T5DecoderLayer, cfg: T5Config, x: torch.Tensor, *,
                  encoder_hidden: torch.Tensor, bias: torch.Tensor,
                  enc_kv_mask: Optional[torch.Tensor],
                  gen: Optional[torch.Generator] = None,
                  tp=None) -> torch.Tensor:
    """One teacher-forced decoder block (JAX ``decoder_block``): causal
    self-attention with the position bias and no padding mask,
    cross-attention with the encoder mask and no bias, FF. Plain RMSNorm;
    ``attention_impl="row"`` runs ``attention_xla`` here, as in the JAX
    package, whose ``multi_head_attention`` has no row branch."""
    eps, rate = cfg.layer_norm_epsilon, cfg.dropout_rate
    impl = "xla" if cfg.attention_impl == "row" else cfg.attention_impl
    h = rms_norm(x, p.self_ln, eps)
    x = x + dropout(_attention_block(p.self_attn, cfg, h, bias=bias,
                                     kv_mask=None, causal=True, impl=impl,
                                     tp=tp), rate, gen)
    h = rms_norm(x, p.cross_ln, eps)
    x = x + dropout(_attention_block(p.cross_attn, cfg, h, encoder_hidden,
                                     bias=None, kv_mask=enc_kv_mask,
                                     impl=impl, tp=tp), rate, gen)
    h = rms_norm(x, p.ff_ln, eps)
    return x + dropout(_ff_block(p.ff, cfg, h, gen, tp), rate, gen)


def remat_layer(cfg: T5Config, gen: Optional[torch.Generator], fn, *args):
    """``fn(*args)``; under ``cfg.remat`` (and autograd) the layer's
    activations are recomputed in the backward pass instead of kept. The
    recompute replays the layer's dropout: it runs from the generator state
    the forward started with, and then puts the generator back."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    state = None if gen is None else gen.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if gen is None or len(calls) == 1:  # the forward pass itself
            return fn(*a)
        now = gen.get_state()
        gen.set_state(state)
        try:
            return fn(*a)
        finally:
            gen.set_state(now)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def t5_encode(params: T5, cfg: T5Config, inputs_embeds: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              dropout_gen: Optional[torch.Generator] = None,
              tp=None) -> torch.Tensor:
    """Encoder stack over input embeddings (B, L, D); attention_mask (B, L)
    in {0, 1}. ``dropout_gen`` enables training dropout (rate
    ``cfg.dropout_rate``); ``None`` is deterministic evaluation.
    ``cfg.attention_impl`` picks the row path or the head-layout path
    (module docstring); ``tp`` runs it tensor-parallel. Under
    ``train/profiling`` the span ``mpr.t5.encode``."""
    with profiling.span("mpr.t5.encode"):
        enc = params.encoder
        B, L, D = inputs_embeds.shape
        eps, rate, gen = cfg.layer_norm_epsilon, cfg.dropout_rate, dropout_gen
        bias = compute_position_bias(enc.rel_bias, L, L, bidirectional=True,
                                     cfg=cfg)  # (1, H, L, L)
        x = dropout(inputs_embeds, rate, gen)
        if cfg.attention_impl != "row":
            for p in enc.block:
                x = remat_layer(cfg, gen, lambda x, p=p: encoder_block(
                    p, cfg, x, bias=bias, kv_mask=attention_mask, gen=gen,
                    tp=tp), x)
            return dropout(rms_norm(x, enc.final_ln, eps), rate, gen)

        def row_layer(x, p):
            H = local_heads(p.attn, cfg)
            W = H * cfg.d_kv
            h = copy_to_model(fused_rms_norm(x, p.attn_ln, eps), tp)
            # a reshape of the GEMM output: contiguous, as K1 needs it
            qkv = dense(h, p.attn.qkv).reshape(B, L, 3 * W)
            o = row_attention_packed(qkv, head_rows(bias[0], H, tp, 0),
                                     attention_mask, heads=H, scale=1.0)
            o = reduce_from_model(p.attn.o(o.reshape(B * L, W)), tp)
            x = x + dropout(o, rate, gen)
            h = fused_rms_norm(x, p.ff_ln, eps)
            return x + dropout(_ff_block(p.ff, cfg, h, gen, tp), rate, gen)

        x = x.reshape(B * L, D)
        for p in enc.block:
            x = remat_layer(cfg, gen, lambda x, p=p: row_layer(x, p), x)
        x = dropout(fused_rms_norm(x, enc.final_ln, eps), rate, gen)
        return x.reshape(B, L, D)


# ---------------------------------------------------------------------------
# Teacher-forced decoder and loss
# ---------------------------------------------------------------------------


def t5_decode_train(params: T5, cfg: T5Config, encoder_hidden: torch.Tensor,
                    encoder_mask: Optional[torch.Tensor],
                    decoder_input_ids: torch.Tensor,
                    dropout_gen: Optional[torch.Generator] = None,
                    tp=None) -> torch.Tensor:
    """Teacher-forced decoder: LM logits (B, T, V) in fp32, cast from the
    compute-dtype product. Decoder self-attention is causal with no padding
    mask (HF's default when no decoder_attention_mask is passed)."""
    dec = params.decoder
    T = decoder_input_ids.shape[1]
    rate, gen = cfg.dropout_rate, dropout_gen
    x = dropout(params.shared[decoder_input_ids.long()], rate, gen)
    bias = compute_position_bias(dec.rel_bias, T, T, bidirectional=False,
                                 cfg=cfg)
    for p in dec.block:
        x = remat_layer(cfg, gen, lambda x, p=p: decoder_block(
            p, cfg, x, encoder_hidden=encoder_hidden, bias=bias,
            enc_kv_mask=encoder_mask, gen=gen, tp=tp), x)
    return lm_logits(params, cfg, x, gen)


def lm_logits(params: T5, cfg: T5Config, x: torch.Tensor,
              dropout_gen=None) -> torch.Tensor:
    """The teacher-forced head over the last decoder block's output: the
    final RMSNorm, dropout, the tied-embedding scaling and the logits
    (B, T, V) in fp32, cast from the compute-dtype product."""
    x = dropout(rms_norm(x, params.decoder.final_ln, cfg.layer_norm_epsilon),
                cfg.dropout_rate, dropout_gen)
    x = x * (cfg.d_model ** -0.5)  # tied-embedding output scaling
    return dense(x, params.shared.to(x.dtype)).float()


def label_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed negative log-likelihood of the labels that are not -100
    (fp32 scalar); the caller divides by its count of them."""
    valid = labels != -100
    safe = labels.masked_fill(~valid, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -torch.sum(token_ll * valid)


def shift_right(labels: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """HF ``_shift_right``: prepend decoder_start, drop last, -100 -> pad."""
    start = torch.full_like(labels[:, :1], cfg.decoder_start_token_id)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return shifted.masked_fill(shifted == -100, cfg.pad_token_id)


def t5_loss(params: T5, cfg: T5Config, inputs_embeds: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            dropout_gen: Optional[torch.Generator] = None,
            tp=None) -> torch.Tensor:
    """Cross-entropy with -100 ignored, mean over the valid tokens (HF
    parity; an all-ignored batch gives 0). ``dropout_gen`` for training;
    ``tp`` tensor-parallel."""
    enc = t5_encode(params, cfg, inputs_embeds, attention_mask, dropout_gen,
                    tp)
    logits = t5_decode_train(params, cfg, enc, attention_mask,
                             shift_right(labels, cfg), dropout_gen, tp)
    return label_nll(logits, labels) / torch.clamp(
        (labels != -100).sum(), min=1)


# ---------------------------------------------------------------------------
# Teacher-forced forward with the attention maps (the --eval diagnostic)
# ---------------------------------------------------------------------------


def attention_probs(p: T5Attention, cfg: T5Config, x_q: torch.Tensor,
                    x_kv: torch.Tensor, *, bias: Optional[torch.Tensor],
                    kv_mask: Optional[torch.Tensor], causal: bool):
    """JAX ``_attention_probs``: the attention block's output and its fp32
    softmax probabilities (B, H, Lq, Lk), in plain torch on every device.
    The scores are rounded to the compute dtype before the fp32 bias; the
    key mask and the causal mask REPLACE masked scores with -1e9."""
    B, Lq, _ = x_q.shape
    Lk = x_kv.shape[1]
    H, Dh, W = cfg.num_heads, cfg.d_kv, cfg.inner_dim

    def heads(y, L):
        return y.view(B, L, H, Dh).transpose(1, 2)

    q = heads(dense(x_q, p.qkv[:W]), Lq)
    k = heads(dense(x_kv, p.qkv[W:2 * W]), Lk)
    v = heads(dense(x_kv, p.qkv[2 * W:]), Lk)
    scores = torch.matmul(q, k.transpose(-1, -2)).float()
    if bias is not None:
        scores = scores + bias.float()
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask.bool()[:, None, None, :], -1e9)
    if causal:
        pos = torch.arange(max(Lq, Lk), device=x_q.device)
        scores = scores.masked_fill(pos[None, :Lk] > pos[:Lq, None], -1e9)
    probs = torch.softmax(scores, dim=-1)
    o = torch.matmul(probs.to(q.dtype), v)
    return p.o(o.transpose(1, 2).reshape(B, Lq, W)), probs


@torch.no_grad()
def t5_forward_with_attentions(params: T5, cfg: T5Config,
                               inputs_embeds: torch.Tensor,
                               attention_mask: Optional[torch.Tensor],
                               decoder_input_ids: torch.Tensor) -> dict:
    """Teacher-forced forward over ``decoder_input_ids`` returning every
    attention map (JAX ``t5_forward_with_attentions``, the HF
    ``output_attentions=True`` analogue): ``encoder_attentions`` (L, B, H,
    Lsrc, Lsrc), ``decoder_attentions`` (L, B, H, T, T),
    ``cross_attentions`` (L, B, H, T, Lsrc), fp32 ``logits`` (B, T, V) and
    ``encoder_hidden``. Plain torch (no kernel), as the JAX function is
    plain XLA; the first decoder input is the raw ``shared[ids]``."""
    enc, dec = params.encoder, params.decoder
    eps = cfg.layer_norm_epsilon
    L, T = inputs_embeds.shape[1], decoder_input_ids.shape[1]
    enc_bias = compute_position_bias(enc.rel_bias, L, L, bidirectional=True,
                                     cfg=cfg)
    x, enc_attn = inputs_embeds, []
    for p in enc.block:
        h = rms_norm(x, p.attn_ln, eps)
        a, probs = attention_probs(p.attn, cfg, h, h, bias=enc_bias,
                                   kv_mask=attention_mask, causal=False)
        x = x + a
        x = x + _ff_block(p.ff, cfg, rms_norm(x, p.ff_ln, eps))
        enc_attn.append(probs)
    enc_hidden = rms_norm(x, enc.final_ln, eps)

    dec_bias = compute_position_bias(dec.rel_bias, T, T, bidirectional=False,
                                     cfg=cfg)
    y, dec_attn, cross_attn = params.shared[decoder_input_ids.long()], [], []
    for p in dec.block:
        h = rms_norm(y, p.self_ln, eps)
        a, probs = attention_probs(p.self_attn, cfg, h, h, bias=dec_bias,
                                   kv_mask=None, causal=True)
        y = y + a
        dec_attn.append(probs)
        a, probs = attention_probs(
            p.cross_attn, cfg, rms_norm(y, p.cross_ln, eps), enc_hidden,
            bias=None, kv_mask=attention_mask, causal=False)
        y = y + a
        cross_attn.append(probs)
        y = y + _ff_block(p.ff, cfg, rms_norm(y, p.ff_ln, eps))
    y = rms_norm(y, dec.final_ln, eps) * (cfg.d_model ** -0.5)
    return {
        "encoder_attentions": torch.stack(enc_attn),
        "decoder_attentions": torch.stack(dec_attn),
        "cross_attentions": torch.stack(cross_attn),
        "logits": dense(y, params.shared.to(y.dtype)).float(),
        "encoder_hidden": enc_hidden,
    }


# ---------------------------------------------------------------------------
# Greedy decode over row caches
# ---------------------------------------------------------------------------


def _precompute_cross_kv(params: T5, cfg: T5Config,
                         encoder_hidden: torch.Tensor
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Cross-attention K/V depend only on the encoder output: once per
    call, per layer, as (B, Lk, W) rows (W the rank's heads under TP)."""
    out = []
    for p in params.decoder.block:
        W = local_heads(p.cross_attn, cfg) * cfg.d_kv
        out.append((dense(encoder_hidden, p.cross_attn.qkv[W:2 * W]),
                    dense(encoder_hidden, p.cross_attn.qkv[2 * W:])))
    return out


@torch.no_grad()
def t5_greedy_decode(params: T5, cfg: T5Config,
                     encoder_hidden: torch.Tensor,
                     encoder_mask: Optional[torch.Tensor],
                     max_new_tokens: int = 20,
                     early_stop: bool = True, tp=None) -> torch.Tensor:
    """Greedy generation: (B, 1 + max_new_tokens) int32 sequences starting
    with decoder_start_token_id; positions after EOS are pad.

    Matches HF ``generate(do_sample=False, max_new_tokens=N)``. The JAX
    ``lax.while_loop`` becomes the Python loop of ``models/greedy.py``; the
    self-attention caches are (B, T, W) buffers updated in place. Both
    ``decode_layers`` settings run this one loop over the layers: the JAX
    package's "unroll" and "scan" are the same math, pinned bit-equal by
    its tests. ``cfg.decode_attention_impl`` picks K6 or K7 for every self-
    and cross-attention of the loop. Under ``tp`` the caches and the kernels
    hold the rank's heads, with one reduce after each ``o`` and each FF
    (the JAX TP predict step).

    A step is cut at its attention calls into 2L + 1 segments
    (:func:`_step_in`, :func:`_step_mid`, :func:`_step_out`): the norms,
    projections, residual adds, FF and cache writes between them, CUDA
    graphs on the card without ``tp`` (``models/greedy.py``). The attention
    calls (into the state's fixed output) and the LM head stay Python calls,
    through the module's ``decode_attention_for`` and ``dense``. Under
    ``train/profiling`` the span ``mpr.t5.decode`` and in it the greedy
    loop's, prefix ``t5``; none inside the loop over the layers."""
    with profiling.span("mpr.t5.decode"):
        attend = decode_attention_for(cfg.decode_attention_impl)
        dec = params.decoder
        B = encoder_hidden.shape[0]
        H = local_heads(dec.block[0].self_attn, cfg)
        W, T = H * cfg.d_kv, max_new_tokens
        dev, dt = encoder_hidden.device, encoder_hidden.dtype
        cross = _precompute_cross_kv(params, cfg, encoder_hidden)
        enc_kv_mask = (None if encoder_mask is None
                       else encoder_mask.to(torch.int32))
        # the causal decoder position bias, keys after the step masked out
        # of it (in its own dtype, as JAX masks it), made once as fp32
        # (T, H, T): step t reads the contiguous (H, T) row step_bias[t]
        full_bias = head_rows(compute_position_bias(
            dec.rel_bias, T, T, bidirectional=False, cfg=cfg)[0], H, tp, 0)
        key_pos = torch.arange(T, device=dev)
        future = key_pos[None, :] > key_pos[:, None]  # [t, j]: key j after t
        step_bias = (full_bias.masked_fill(future[None], -1e9).float()
                     .transpose(0, 1).contiguous())

        def step(st: _DecodeState, run, t: int):
            x = _decode_step(params, cfg, st, run, attend, step_bias[t],
                             cross, enc_kv_mask, H, tp)
            return None if run.capturing else dense(
                x, params.shared.to(x.dtype))

        def body(st: _DecodeState, g):  # the next call resets st's ids
            return greedy.decode("t5", step, st, g, st.reset(cfg),
                                 eos=cfg.eos_token_id, pad=cfg.pad_token_id,
                                 early_stop=early_stop).clone()

        # the segments hold neither the cross K/V nor the encoder mask: one
        # set serves every encoder width
        return greedy.hold((cfg, B, T, dt, dev), (params.shared, dec),
                           lambda: _DecodeState(len(dec.block), B, T, W, dt,
                                                dev), dev, body, tp)


class _DecodeState:
    """What a greedy decode writes in place: every layer's self-attention
    k and v caches in one (2, L, B, T, W) buffer (k then v), the
    (B, T + 1) ids, the (1,) step index and the attention output (B, W).
    Made outside inference mode, so that a set of graphs that outlives a
    server's call can be reset by a later call outside it."""

    def __init__(self, L: int, B: int, T: int, W: int, dtype, device):
        with torch.inference_mode(False):
            self.kv = torch.empty((2, L, B, T, W), dtype=dtype, device=device)
            self.tokens = torch.empty((B, T + 1), dtype=torch.int32,
                                      device=device)
            self.step = torch.empty((1,), dtype=torch.long, device=device)
            self.o = torch.empty((B, W), dtype=dtype, device=device)
            self.self_k = list(self.kv[0])
            self.self_v = list(self.kv[1])

    def reset(self, cfg: T5Config) -> torch.Tensor:
        """Zeroed caches and step, the ids at the start token; -> the ids."""
        self.kv.zero_()
        self.tokens.fill_(cfg.pad_token_id)
        self.tokens[:, 0] = cfg.decoder_start_token_id
        self.step.zero_()
        return self.tokens


def _step_in(params: T5, cfg: T5Config, st: _DecodeState, li: int,
             x: Optional[torch.Tensor], o: Optional[torch.Tensor], tp):
    """The segment before layer ``li``'s self-attention: the embedding of
    the ids at the step (``li`` 0), or the rest of layer ``li - 1`` (the
    cross ``o`` projection of ``o``, the residual add, the FF); then
    ``self_ln``, the q/k/v product and k, v written into the caches at the
    step. -> (x, q)."""
    dec, eps = params.decoder, cfg.layer_norm_epsilon
    if li == 0:
        x = params.shared[st.tokens.index_select(1, st.step)[:, 0].long()]
    else:
        p = dec.block[li - 1]
        x = x + reduce_from_model(p.cross_attn.o(o), tp)
        x = x + _ff_block(p.ff, cfg, rms_norm(x, p.ff_ln, eps), tp=tp)
    p = dec.block[li]
    W = st.o.shape[1]
    qkv = dense(rms_norm(x, p.self_ln, eps), p.self_attn.qkv)  # (B, 3W)
    for cache, kv in ((st.self_k[li], qkv[:, None, W:2 * W]),
                      (st.self_v[li], qkv[:, None, 2 * W:])):
        cache.index_copy_(1, st.step, kv.to(cache.dtype))
    return x, qkv[:, :W]


def _step_mid(params: T5, cfg: T5Config, li: int, x: torch.Tensor,
              o: torch.Tensor, tp):
    """The segment between layer ``li``'s two attentions: the self ``o``
    projection of ``o``, the residual add, ``cross_ln`` and the cross q
    product. -> (x, q)."""
    p = params.decoder.block[li]
    x = x + reduce_from_model(p.self_attn.o(o), tp)
    h = rms_norm(x, p.cross_ln, cfg.layer_norm_epsilon)
    return x, dense(h, p.cross_attn.qkv[:o.shape[1]])


def _step_out(params: T5, cfg: T5Config, st: _DecodeState, x: torch.Tensor,
              o: torch.Tensor, tp) -> torch.Tensor:
    """The segment after the last cross-attention: the rest of the last
    layer, ``final_ln`` and the tied-embedding scaling; the step index
    advanced. -> the LM head's input (B, D)."""
    dec, eps = params.decoder, cfg.layer_norm_epsilon
    p = dec.block[-1]
    x = x + reduce_from_model(p.cross_attn.o(o), tp)
    x = x + _ff_block(p.ff, cfg, rms_norm(x, p.ff_ln, eps), tp=tp)
    st.step.add_(1)
    return rms_norm(x, dec.final_ln, eps) * (cfg.d_model ** -0.5)


def _decode_step(params: T5, cfg: T5Config, st: _DecodeState, run, attend,
                 self_bias, cross, enc_kv_mask, heads: int,
                 tp) -> torch.Tensor:
    """One step through the 2L + 1 segments in order, each run by
    ``run(i, fn, *args)``; between them the attention calls into ``st.o``,
    skipped while ``run.capturing``. -> the LM head's input."""
    L = len(params.decoder.block)
    x, q = run(0, _step_in, params, cfg, st, 0, None, None, tp)
    for li in range(L):
        if not run.capturing:
            attend(q, st.self_k[li], st.self_v[li], bias=self_bias,
                   heads=heads, out=st.o)
        x, q = run(2 * li + 1, _step_mid, params, cfg, li, x, st.o, tp)
        if not run.capturing:
            attend(q, *cross[li], kv_mask=enc_kv_mask, heads=heads, out=st.o)
        if li + 1 < L:
            x, q = run(2 * li + 2, _step_in, params, cfg, st, li + 1, x,
                       st.o, tp)
    return run(2 * L, _step_out, params, cfg, st, x, st.o, tp)


@torch.no_grad()
def t5_spec_greedy_decode(params: T5, cfg: T5Config,
                          encoder_hidden: torch.Tensor,
                          encoder_mask: Optional[torch.Tensor],
                          draft_ids: torch.Tensor, max_new_tokens: int = 20,
                          block: int = 4,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """Hint-draft speculative greedy decode (JAX ``t5_spec_greedy_decode``):
    the ids of :func:`t5_greedy_decode` (early-stop semantics) in fewer
    decoder passes when the drafts match.

    ``draft_ids`` (B, Dw) proposes, per row, the token of each absolute
    output slot (slot m + 1's candidate is ``draft_ids[:, m]``). Each pass
    runs the decoder once over ``block + 1`` positions [current, S drafts]
    at per-row offsets ``n`` and accepts the longest matched draft prefix
    plus the bonus token, truncated at the first emitted EOS and at the
    budget; every accepted token is an argmax given a verified prefix, so
    the ids do not depend on the drafts. The loop stops when no unfinished
    row has budget left, checked on the host after each pass.

    Per-row mechanics: the self-attention caches hold T + S slots, written
    at each row's positions by an indexed write (the JAX package's one-hot
    matmul is a TPU workaround); slots at or past a row's frontier hold
    stale K/V and are masked in the (B, S+1, Tc) key validity folded into
    each row's bias rows of the (H, Tc, Tc) causal position table.
    ``stats["passes"]``, when given, receives the number of passes.

    Under ``train/profiling`` the spans and counters of
    :func:`t5_greedy_decode`, a step a pass, its host check the sync."""
    with profiling.span("mpr.t5.decode"):
        return _spec_greedy_decode(params, cfg, encoder_hidden, encoder_mask,
                                   draft_ids, max_new_tokens, block, stats)


def _spec_greedy_decode(params: T5, cfg: T5Config,
                        encoder_hidden: torch.Tensor,
                        encoder_mask: Optional[torch.Tensor],
                        draft_ids: torch.Tensor, max_new_tokens: int,
                        block: int, stats: Optional[dict]) -> torch.Tensor:
    decode_attention_for(cfg.decode_attention_impl)  # an unknown name raises
    indicator = cfg.decode_attention_impl != "xla"
    dec = params.decoder
    B = encoder_hidden.shape[0]
    H, W, Dh, T = cfg.num_heads, cfg.inner_dim, cfg.d_kv, max_new_tokens
    S = int(block)
    if S < 1:
        raise ValueError(f"spec decode block {block} is not >= 1")
    Tc = T + S  # block queries can run S past the last real slot
    Dw = draft_ids.shape[1]
    eps = cfg.layer_norm_epsilon
    dev, dt = encoder_hidden.device, encoder_hidden.dtype
    cross = _precompute_cross_kv(params, cfg, encoder_hidden)
    enc_kv_mask = (None if encoder_mask is None
                   else encoder_mask.to(torch.int32))
    full_bias = compute_position_bias(dec.rel_bias, Tc, Tc,
                                      bidirectional=False, cfg=cfg)[0].float()
    self_k = [torch.zeros((B, Tc, W), dtype=dt, device=dev)
              for _ in dec.block]
    self_v = [torch.zeros_like(c) for c in self_k]
    tokens = torch.full((B, T + 1), cfg.pad_token_id, dtype=torch.int32,
                        device=dev)
    tokens[:, 0] = cfg.decoder_start_token_id
    n = torch.zeros((B,), dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    jj = torch.arange(S + 1, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    kpos = torch.arange(Tc, device=dev)
    slots = torch.arange(T + 1, device=dev)[None, :]
    draft_ids = draft_ids.to(dev, torch.int32)

    def heads(y):  # (B, L, W) -> (B, H, L, Dh) view
        return y.view(B, y.shape[1], H, Dh).transpose(1, 2)

    def attend(q, k, v, bias=None, bias_h=None, kv_mask=None):
        if indicator:
            return block_attention_indicator(q, k, v, heads=H, bias=bias,
                                             kv_mask=kv_mask)
        o = multi_head_attention(heads(q), heads(k), heads(v), bias=bias_h,
                                 kv_mask=kv_mask, scale=1.0, impl="xla")
        return o.transpose(1, 2).reshape(B, S + 1, W)

    passes = 0
    # no row has finished or spent its budget before the first pass, so
    # the first check needs no sync
    pending = B > 0 and T > 0
    while pending:
        with profiling.span("mpr.t5.decode.step"):
            profiling.count("t5.decode_steps")
            passes += 1
            nc = torch.clamp(n, max=T - 1)
            cur = tokens[rows[:, 0], nc]
            dslot = nc[:, None] + jj[None, 1:] - 1  # (B, S)
            drafts = torch.where(
                dslot < Dw,
                torch.gather(draft_ids, 1, torch.clamp(dslot, 0, Dw - 1)),
                cfg.pad_token_id)
            x = params.shared[torch.cat([cur[:, None], drafts], 1).long()]
            qpos = nc[:, None] + jj[None, :]  # (B, S+1)
            # per-(row, query) additive bias: position row + key validity
            valid = kpos[None, None, :] <= qpos[:, :, None]  # (B, S+1, Tc)
            bias_h = torch.where(valid[:, None], full_bias[:, qpos]
                                 .transpose(0, 1), -1e9)  # (B, H, S+1, Tc)
            bias = bias_h.transpose(1, 2)  # (B, S+1, H, Tc)
            for li, p in enumerate(dec.block):
                h = rms_norm(x, p.self_ln, eps)
                qkv = dense(h, p.self_attn.qkv)  # (B, S+1, 3W)
                self_k[li][rows, qpos] = qkv[..., W:2 * W]
                self_v[li][rows, qpos] = qkv[..., 2 * W:]
                o = attend(qkv[..., :W], self_k[li], self_v[li], bias, bias_h)
                x = x + p.self_attn.o(o)

                h = rms_norm(x, p.cross_ln, eps)
                q = dense(h, p.cross_attn.qkv[:W])
                x = x + p.cross_attn.o(attend(q, *cross[li],
                                              kv_mask=enc_kv_mask))

                h = rms_norm(x, p.ff_ln, eps)
                x = x + _ff_block(p.ff, cfg, h)
            x = rms_norm(x, dec.final_ln, eps)
            x = x * (cfg.d_model ** -0.5)
            logits = dense(x, params.shared.to(x.dtype))
            o_tok = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, S+1)

            # accept the longest matched draft prefix, plus the bonus token
            match = (o_tok[:, :S] == drafts).to(torch.int32)
            acc = torch.cumprod(match, dim=1).sum(dim=1) + 1
            # exact per-row EOS stop: truncate at the first emitted EOS
            is_eos = (o_tok == cfg.eos_token_id) & (jj[None, :] < acc[:, None])
            any_eos = is_eos.any(dim=1)
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
            acc = torch.where(any_eos, first_eos + 1, acc)
            cap = T - n
            hit_eos = any_eos & (first_eos + 1 <= cap)
            acc = torch.where(finished, 0, torch.minimum(acc, cap))

            rel = slots - n[:, None] - 1
            write = (rel >= 0) & (rel < acc[:, None])
            got = torch.gather(o_tok, 1, torch.clamp(rel, 0, S))
            tokens = torch.where(write, got, tokens)
            n = n + acc
            finished = finished | hit_eos
            with profiling.span("mpr.t5.decode.eos_sync"):
                profiling.count("t5.eos_syncs")
                pending = bool((~finished & (n < T)).any())
    if stats is not None:
        stats["passes"] = passes
    return tokens
