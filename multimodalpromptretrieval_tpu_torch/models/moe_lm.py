"""A decoder-only MoE language model as MPR_Gen's answer generator: the
DeepSeek-V3 block of Kimi-VL-A3B / Moonlight-16B-A3B.

The JAX package has no counterpart; the port added it beside T5 (the
generator is chosen by ``MPRGenConfig.lm``). Per layer, x the residual
stream (DeepSeek-V3's published equations, ``q_lora_rank`` null):

* attention: ``h = RMSNorm(x)``; ``q = W_q h`` per head [nope 128 | pe
  64]; ``[c | k_pe] = W_kva h`` (512 + 64); ``c = RMSNorm_kv(c)``;
  ``[k_nope | v] = W_kvb c`` per head (128 + 128); RoPE on ``q_pe`` and
  the shared ``k_pe`` in DeepSeek's interleaved-pair layout (pairs
  de-interleaved, then ``rotate_half``), theta ``rope_theta``; scores
  ``(q_nope . k_nope + q_pe . k_pe) / sqrt(192)``, causal over the row's
  valid positions; ``x += W_o concat_h(P v)``;
* FFN: layer < ``first_k_dense_replace`` a SiLU-gated MLP of width
  ``intermediate_size``; after it ``ops/moe``: sigmoid router in fp32,
  top ``num_experts_per_tok`` by score + correction bias, weights
  normalised and scaled by ``routed_scaling_factor``, the routed experts
  plus ``n_shared_experts`` shared ones as one gated MLP of width
  ``n_shared_experts * moe_intermediate_size``;
* a final RMSNorm and the untied head.

Generation (:func:`lm_generate`): the prompt is left-padded behind the
visual prefix, so every row ends at one column; positions come from the
mask (``cumsum - 1``). The prefill (:func:`lm_prefill`) runs the
non-absorbed form over [prefix || prompt] and writes each layer's latent
cache, one (c | k_pe) row of ``kv_lora_rank + qk_rope_head_dim`` values a
token; each greedy step (:func:`lm_decode`) runs the absorbed form:
``q_lat = q_nope W_UK`` per head, the latent attention kernel over the
cache (``ops/mla``), then ``W_UV`` and ``W_o``. The head scores only the
last position. Ids come back as T5's do, from the same greedy loop
(``models/greedy.py``): (B, 1 + max_new_tokens) int32, column 0 the pad
id, pad after a row's EOS.

A step is cut at its Python calls (K11, the router and the experts, the
LM head) into 2 x layers + 1 segments (:func:`_step_in`,
:func:`_step_mid`, :func:`_step_out`): the norms, projections, rope,
cache writes at a device column, absorbed query, ``W_UV`` / ``W_o``,
shared experts and residual adds between them. On CUDA tensors each
segment is a CUDA graph (one set per shape and weights, holding the key's
:class:`DecodeState`, which the prefill writes), replayed every step; the
calls between them write into the state's fixed targets. On the CPU the
same segments run as plain calls.

The weights of a served LM are held in the compute dtype only
(:func:`hold_in`; the correction bias stays fp32): fp32 masters of the
16 B-parameter model and a bf16 copy do not fit the card together.

Module-level calls the benchmark may wrap at call time: :func:`lm_head`,
:func:`lm_prefill`, :func:`lm_decode`, ``ops.moe.route``,
``ops.moe.moe_experts`` and ``ops.mla.mla_decode_attention``. Under
``train/profiling``: spans ``mpr.lm.prefill``, ``mpr.lm.decode`` and in
it the greedy loop's (prefix ``lm``), ``mpr.moe.route``,
``mpr.moe.experts`` and ``mpr.mla.decode``; counters ``lm.prefill_tokens``
(the rows' valid tokens, read from the device only while spans are on) and
``moe.rows``. A wrapper on anything inside a segment runs only at capture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.models import greedy
from multimodalpromptretrieval_tpu_torch.ops import graphs, mla, moe
from multimodalpromptretrieval_tpu_torch.ops.layers import dense, param
from multimodalpromptretrieval_tpu_torch.ops.norm import fused_rms_norm
from multimodalpromptretrieval_tpu_torch.train import profiling


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The published ``config.json`` keys that shape the model
    (Kimi-VL-A3B-Instruct's text config by default; the rest, such as
    ``max_position_embeddings`` or ``seq_aux``, change nothing served),
    with ``pad_token_id`` / ``eos_token_id`` those of the tokenizer the
    port serves with, and ``init_std`` of the seeded init (DeepSeek's
    ``initializer_range``)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    init_std: float = 0.02

    def __post_init__(self):
        unsupported = {
            "q_lora_rank": (self.q_lora_rank, None),
            "topk_method": (self.topk_method, "noaux_tc"),
            "n_group": (self.n_group, 1), "topk_group": (self.topk_group, 1),
            "moe_layer_freq": (self.moe_layer_freq, 1),
            "scoring_func": (self.scoring_func, "sigmoid"),
            "hidden_act": (self.hidden_act, "silu"),
            "rope_scaling": (self.rope_scaling, None),
            "attention_bias": (self.attention_bias, False),
            "tie_word_embeddings": (self.tie_word_embeddings, False),
            "num_key_value_heads": (self.num_key_value_heads,
                                    self.num_attention_heads)}
        for key, (got, want) in unsupported.items():
            if got != want:
                raise ValueError(f"LMConfig: {key}={got!r} is not supported "
                                 f"(only {want!r})")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        """Values a token and layer in the latent cache: c, then k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def shared_width(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size

    @staticmethod
    def from_dict(d: dict) -> "LMConfig":
        """The config's fields out of a ``config.json``-like dict (other
        keys ignored)."""
        names = {f.name for f in dataclasses.fields(LMConfig)}
        return LMConfig(**{k: v for k, v in d.items() if k in names})


def refuse_options(**options) -> None:
    """``ValueError`` naming the first option set (truthy) that the LM
    generator does not take: it serves in the compute dtype, one greedy
    token a step, on one device, from seeded weights."""
    for name, value in options.items():
        if value:
            raise ValueError(f"{name}={value!r} is not supported with the LM "
                             "generator (served in its compute dtype, "
                             "greedily, on one device)")


class LMLayer(nn.Module):
    """One block's weights, torch (out, in) layout: ``q`` rows per head
    [nope | pe], ``kva`` [c | k_pe], ``kvb`` rows per head [k_nope | v],
    ``gate_up`` / ``experts_gate_up`` / ``shared_gate_up`` [gate; up]."""

    def __init__(self, cfg: LMConfig, dense_ffn: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, H, s = cfg.hidden_size, cfg.num_attention_heads, cfg.init_std
        self.attn_norm = param((d,), generator, fill=1.0)
        self.q = param((H * cfg.qk_head_dim, d), generator, std=s)
        self.kva = param((cfg.cache_width, d), generator, std=s)
        self.kv_norm = param((cfg.kv_lora_rank,), generator, fill=1.0)
        self.kvb = param((H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                          cfg.kv_lora_rank), generator, std=s)
        self.o = param((d, H * cfg.v_head_dim), generator, std=s)
        self.ffn_norm = param((d,), generator, fill=1.0)
        if dense_ffn:
            w = cfg.intermediate_size
            self.gate_up = param((2 * w, d), generator, std=s)
            self.down = param((d, w), generator, std=s)
        else:
            E, w = cfg.n_routed_experts, cfg.moe_intermediate_size
            self.router = param((E, d), generator, std=s)
            self.router_bias = param((E,), generator, std=s)
            self.experts_gate_up = param((E, 2 * w, d), generator, std=s)
            self.experts_down = param((E, d, w), generator, std=s)
            self.shared_gate_up = param((2 * cfg.shared_width, d), generator,
                                        std=s)
            self.shared_down = param((d, cfg.shared_width), generator, std=s)


class MoELM(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm``, the untied ``head``
    (V, d). ``generator=None`` leaves the weights to be filled."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, V = cfg.hidden_size, cfg.vocab_size
        self.embed = param((V, d), generator, std=cfg.init_std)
        self.layers = nn.ModuleList(
            LMLayer(cfg, i < cfg.first_k_dense_replace, generator)
            for i in range(cfg.num_hidden_layers))
        self.final_norm = param((d,), generator, fill=1.0)
        self.head = param((V, d), generator, std=cfg.init_std)


def hold_in(lm: MoELM, dtype: torch.dtype) -> MoELM:
    """Cast the LM's weights to ``dtype`` in place (the correction biases
    stay fp32: they decide near ties of the fp32 router)."""
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if not name.endswith("router_bias") and p.dtype != dtype:
                p.data = p.data.to(dtype)
    return lm


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K3 on the card (T5 / DeepSeek RMSNorm numerics)."""
    return fused_rms_norm(x.contiguous(), w, eps)


def rope_tables(pos: torch.Tensor, dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (..., dim) fp32 at integer positions ``pos`` (...)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=pos.device,
                                        dtype=torch.float32) / dim))
    freqs = pos.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's RoPE on interleaved pairs: (x0, x1, x2, x3, ...) ->
    (x0, x2, ..., x1, x3, ...), then ``x cos + rotate_half(x) sin``, in
    fp32. ``cos`` / ``sin`` broadcast against ``x``."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2).float()
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    return apply_rope(x, cos, sin).to(x.dtype)


def _mlp(h: torch.Tensor, gate_up: torch.Tensor,
         down: torch.Tensor) -> torch.Tensor:
    g, u = dense(h, gate_up).chunk(2, dim=-1)
    return dense(torch.nn.functional.silu(g) * u, down)


def lm_head(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, d) -> (B, V) logits in the compute dtype."""
    return dense(x, weight)


def _routed(p: LMLayer, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    """The router and the routed experts over ``h`` (..., d): (N, d) fp32,
    N the rows of ``h``."""
    with profiling.span("mpr.moe.route"):
        idx, w = moe.route(h, p.router, p.router_bias,
                           cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                           cfg.norm_topk_prob)
    h2 = h.reshape(-1, h.shape[-1])
    k = cfg.num_experts_per_tok
    profiling.count("moe.rows", h2.shape[0] * k)
    with profiling.span("mpr.moe.experts"):
        return moe.moe_experts(h2, idx.reshape(-1, k), w.reshape(-1, k),
                               p.experts_gate_up, p.experts_down)


def _ffn(p: LMLayer, cfg: LMConfig, i: int, h: torch.Tensor) -> torch.Tensor:
    if i < cfg.first_k_dense_replace:
        return _mlp(h, p.gate_up, p.down)
    y = _routed(p, cfg, h)
    y = y + _mlp(h.reshape(y.shape), p.shared_gate_up, p.shared_down).float()
    return y.to(h.dtype).view(h.shape)


def _block(p: LMLayer, cfg: LMConfig, i: int, x: torch.Tensor,
           attend) -> torch.Tensor:
    eps = cfg.rms_norm_eps
    x = x + attend(p, _rms(x, p.attn_norm, eps))
    return x + _ffn(p, cfg, i, _rms(x, p.ffn_norm, eps))


def _project(p: LMLayer, cfg: LMConfig, h: torch.Tensor, cos, sin):
    """q_nope, roped q_pe (..., H, ·), normed c and roped k_pe (..., ·)."""
    H = cfg.num_attention_heads
    q = dense(h, p.q).unflatten(-1, (H, cfg.qk_head_dim))
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    kva = dense(h, p.kva)
    c = _rms(kva[..., :cfg.kv_lora_rank], p.kv_norm, cfg.rms_norm_eps)
    k_pe = _rope(kva[..., cfg.kv_lora_rank:], cos, sin)
    q_pe = _rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))
    return q_nope, q_pe, c, k_pe


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


class DecodeState:
    """What the steps of a decode write in place, made outside inference
    mode (a set of graphs outlives a server's call): the latent ``cache``
    (layers, B, T, kv_lora_rank + rope) in the compute dtype, each row's
    valid length (``lengths``, the next position), the next column to
    write on the device (``column``, (1,)), the prefill's columns on the
    host (``col``), the step's ``tokens`` (B,), and the fixed targets the
    segments read of the two calls between them that feed them: K11's
    output ``o_lat`` (B, H, kv_lora_rank) and the routed experts' sum
    ``experts`` (B, d) fp32. The (B, T) valid-key flags are the call's own
    (``key_ok``), not state."""

    def __init__(self, cfg: LMConfig, B: int, T: int, dtype, device):
        with torch.inference_mode(False):
            self.cache = torch.empty((cfg.num_hidden_layers, B, T,
                                      cfg.cache_width), dtype=dtype,
                                     device=device)
            self.lengths = torch.zeros((B,), dtype=torch.long, device=device)
            self.column = torch.zeros((1,), dtype=torch.long, device=device)
            self.tokens = torch.zeros((B,), dtype=torch.long, device=device)
            self.o_lat = torch.empty((B, cfg.num_attention_heads,
                                      cfg.kv_lora_rank), dtype=dtype,
                                     device=device)
            self.experts = torch.empty((B, cfg.hidden_size),
                                       dtype=torch.float32, device=device)
        self.col = 0


def left_pack(embed: torch.Tensor, prefix: Optional[torch.Tensor],
              input_ids: torch.Tensor, text_mask: torch.Tensor,
              pad_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embeds (B, P + W, d), valid (B, P + W) bool): the prefix, then the
    right-padded prompt moved to the right end of its W columns."""
    B, W = input_ids.shape
    n = text_mask.long().sum(dim=1)
    src = (torch.arange(W, device=input_ids.device)[None, :]
           - (W - n)[:, None])
    ok = src >= 0
    ids = torch.where(ok, input_ids.long().gather(1, src.clamp(min=0)),
                      pad_id)
    x = embed[ids]
    if prefix is None:
        return x, ok
    P = prefix.shape[1]
    ones = torch.ones((B, P), dtype=torch.bool, device=ok.device)
    return (torch.cat([prefix.to(x.dtype), x], dim=1),
            torch.cat([ones, ok], dim=1))


def lm_prefill(params: MoELM, cfg: LMConfig, embeds: torch.Tensor,
               valid: torch.Tensor, state: DecodeState,
               key_ok: torch.Tensor) -> torch.Tensor:
    """The non-absorbed forward over (B, L) columns of ``embeds``
    (``valid`` marks the real ones), writing the latent cache's and
    ``key_ok``'s first L columns; the last column's logits (B, V)."""
    with profiling.span("mpr.lm.prefill"):
        if profiling.enabled():
            profiling.count("lm.prefill_tokens", int(valid.sum()))
        B, L, _ = embeds.shape
        H, R = cfg.num_attention_heads, cfg.qk_rope_head_dim
        pos = (valid.long().cumsum(dim=1) - 1).clamp(min=0)
        cos, sin = rope_tables(pos, R, cfg.rope_theta)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=valid.device).tril()
        allowed = (valid[:, None, None, :] & causal)  # (B, 1, L, L)
        scale = cfg.qk_head_dim ** -0.5

        def attend(i):
            def run(p: LMLayer, h: torch.Tensor) -> torch.Tensor:
                q_nope, q_pe, c, k_pe = _project(p, cfg, h, cos, sin)
                state.cache[i, :, :L, :cfg.kv_lora_rank] = c
                state.cache[i, :, :L, cfg.kv_lora_rank:] = k_pe
                kv = dense(c, p.kvb).unflatten(
                    -1, (H, cfg.qk_nope_head_dim + cfg.v_head_dim))
                k_nope, v = kv.split([cfg.qk_nope_head_dim,
                                      cfg.v_head_dim], -1)
                s = (torch.matmul(q_nope.transpose(1, 2),
                                  k_nope.permute(0, 2, 3, 1))
                     + torch.matmul(q_pe.transpose(1, 2),
                                    k_pe.transpose(1, 2)[:, None]))
                s = s.float().mul_(scale).masked_fill_(~allowed,
                                                       float("-inf"))
                prob = torch.softmax(s, dim=-1).to(v.dtype)
                o = torch.matmul(prob, v.transpose(1, 2))  # (B, H, L, dv)
                return dense(o.transpose(1, 2).flatten(2), p.o)
            return run

        x = embeds
        for i, p in enumerate(params.layers):
            x = _block(p, cfg, i, x, attend(i))
        key_ok[:, :L] = valid.to(torch.int8)
        state.lengths.copy_(valid.long().sum(dim=1))
        state.column.fill_(L)
        state.col = L
        h = _rms(x[:, -1], params.final_norm, cfg.rms_norm_eps)
        return lm_head(h, params.head)


def _step_in(params: MoELM, cfg: LMConfig, st: DecodeState, i: int, prev,
             cos, sin):
    """The segment before layer ``i``'s latent attention: the embedding of
    the step's tokens and the rope tables at the rows' positions (``i``
    0), or the rest of layer ``i - 1`` (:func:`_ffn_rest` of ``prev``);
    then ``attn_norm``, the projections, c and k_pe written into the cache
    at the step's column, and the absorbed query ``q_lat = q_nope W_UK``.
    -> (x, q_lat, q_pe, cos, sin), K11's queries contiguous."""
    if i == 0:
        x = params.embed[st.tokens]
        cos, sin = rope_tables(st.lengths, cfg.qk_rope_head_dim,
                               cfg.rope_theta)
    else:
        x = _ffn_rest(params.layers[i - 1], st, *prev)
    p = params.layers[i]
    H, C, nope = cfg.num_attention_heads, cfg.kv_lora_rank, \
        cfg.qk_nope_head_dim
    q_nope, q_pe, c, k_pe = _project(
        p, cfg, _rms(x, p.attn_norm, cfg.rms_norm_eps), cos, sin)
    cache = st.cache[i]
    cache[..., :C].index_copy_(1, st.column, c[:, None])
    cache[..., C:].index_copy_(1, st.column, k_pe[:, None])
    w_uk = p.kvb.view(H, nope + cfg.v_head_dim, C)[:, :nope]
    # (H, B, nope) @ (H, nope, C): the absorbed query
    q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
    return x, q_lat.contiguous(), q_pe.contiguous(), cos, sin


def _step_mid(params: MoELM, cfg: LMConfig, st: DecodeState, i: int,
              x: torch.Tensor):
    """The segment after layer ``i``'s latent attention: ``W_UV`` and
    ``W_o`` over K11's output (``st.o_lat``), the residual add and
    ``ffn_norm``; on a MoE layer also the shared experts' MLP, which reads
    only the normed h. -> (x, h), or (x, h, shared)."""
    p = params.layers[i]
    H, C, nope = cfg.num_attention_heads, cfg.kv_lora_rank, \
        cfg.qk_nope_head_dim
    w_uv = p.kvb.view(H, nope + cfg.v_head_dim, C)[:, nope:]
    o = torch.bmm(st.o_lat.transpose(0, 1), w_uv.transpose(1, 2))
    x = x + dense(o.transpose(0, 1).flatten(1), p.o)
    h = _rms(x, p.ffn_norm, cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        return x, h
    return x, h, _mlp(h, p.shared_gate_up, p.shared_down)


def _ffn_rest(p: LMLayer, st: DecodeState, x: torch.Tensor, h: torch.Tensor,
              shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rest of a layer after :func:`_step_mid`: the dense MLP of ``h``,
    or the routed experts' sum (``st.experts``) plus the shared experts'
    output; added to the residual ``x``."""
    if shared is None:
        return x + _mlp(h, p.gate_up, p.down)
    return x + (st.experts + shared.float()).to(x.dtype)


def _step_out(params: MoELM, cfg: LMConfig, st: DecodeState,
              prev) -> torch.Tensor:
    """The segment after the last layer's experts: the rest of the layer,
    ``final_norm``; the lengths and the column advanced. -> the LM head's
    input (B, d)."""
    x = _ffn_rest(params.layers[-1], st, *prev)
    st.lengths.add_(1)
    st.column.add_(1)
    return _rms(x, params.final_norm, cfg.rms_norm_eps)


def _decode_step(params: MoELM, cfg: LMConfig, st: DecodeState,
                 key_ok: torch.Tensor, length: int, run) -> torch.Tensor:
    """One step through the 2 x layers + 1 segments in order, each run by
    ``run(i, fn, *args)``. Between them K11 over ``length`` columns and, on
    a MoE layer, the router and the experts, their outputs copied into the
    state's fixed targets; none of them runs while ``run.capturing``. ->
    the LM head's input."""
    scale = cfg.qk_head_dim ** -0.5
    n = cfg.num_hidden_layers
    x, q_lat, q_pe, cos, sin = run(0, _step_in, params, cfg, st, 0, None,
                                   None, None)
    for i, p in enumerate(params.layers):
        if not run.capturing:
            with profiling.span("mpr.mla.decode"):
                o_lat = mla.mla_decode_attention(
                    q_lat, q_pe, st.cache[i], key_ok, length, scale)
            st.o_lat.copy_(o_lat)
        prev = run(2 * i + 1, _step_mid, params, cfg, st, i, x)
        if not run.capturing and i >= cfg.first_k_dense_replace:
            st.experts.copy_(_routed(p, cfg, prev[1]))
        if i + 1 < n:
            x, q_lat, q_pe, _, _ = run(2 * i + 2, _step_in, params, cfg, st,
                                       i + 1, prev, cos, sin)
    return run(2 * n, _step_out, params, cfg, st, prev)


def lm_decode(params: MoELM, cfg: LMConfig, state: DecodeState,
              key_ok: torch.Tensor, logits: torch.Tensor, max_new_tokens: int,
              g: Optional[graphs.Graphs] = None) -> torch.Tensor:
    """Greedy ids from the prefill's ``logits``: the first token from them,
    then a step a token (``models/greedy.py``; the key's graphs ``g`` over
    ``state``), step ``t`` at cache column ``state.col + t - 1``."""
    with profiling.span("mpr.lm.decode"):
        ids = torch.full((logits.shape[0], 1 + max_new_tokens),
                         cfg.pad_token_id, dtype=torch.int32,
                         device=logits.device)

        def step(st: DecodeState, run, t: int):
            st.tokens.copy_(ids[:, t])
            key_ok[:, st.col + t - 1] = 1
            h = _decode_step(params, cfg, st, key_ok, st.col + t, run)
            return None if run.capturing else lm_head(h, params.head)

        return greedy.decode("lm", step, state, g, ids, eos=cfg.eos_token_id,
                             pad=cfg.pad_token_id, first=logits)


@torch.no_grad()
def lm_generate(params: MoELM, cfg: LMConfig, prefix: Optional[torch.Tensor],
                input_ids: torch.Tensor, text_mask: torch.Tensor,
                max_new_tokens: int = 20) -> torch.Tensor:
    """Greedy ids (B, 1 + max_new_tokens) for [prefix || prompt]; the
    prefill writes the state of :func:`greedy.hold`'s path."""
    embeds, valid = left_pack(params.embed, prefix, input_ids, text_mask,
                              cfg.pad_token_id)
    B, L, _ = embeds.shape
    T = L + max(max_new_tokens - 1, 0)
    dev, dt = embeds.device, embeds.dtype
    key_ok = torch.zeros((B, T), dtype=torch.int8, device=dev)

    def body(state: DecodeState, g):
        logits = lm_prefill(params, cfg, embeds, valid, state, key_ok)
        return lm_decode(params, cfg, state, key_ok, logits, max_new_tokens,
                         g)

    return greedy.hold((cfg, B, T, dt, dev), (params,),
                       lambda: DecodeState(cfg, B, T, dt, dev), dev, body)
