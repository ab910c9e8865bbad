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

Kimi-Linear-48B-A3B (``linear_attn_config``, ``mla_use_nope``) mixes two
kinds of attention layer (:meth:`LMConfig.kind`): MLA as above but with no
rotation (NoPE: ``q_pe`` and ``k_pe`` enter the scores as they are), and
KDA (Kimi Delta Attention, ``ops/kda``): ``h = RMSNorm(x)``; ``[q | k |
v] = W_qkv h`` (heads of ``kda_head_dim``), each through a depthwise
causal convolution of ``kda_conv_size`` taps and SiLU; ``g = -exp(A_log)
softplus(W_fb W_fa h + dt_bias)`` a channel, ``beta = sigmoid(W_b h)`` a
head; the gated delta rule over q / k (L2-normalised) and v; ``x += W_o
(RMSNorm(o) * w * sigmoid(W_gb W_ga h))``. Its MoE holds one
expert-parallel rank's share: the router scores all ``n_routed_experts x
ep_size`` experts and picks its top k, this model holds rank 0's
``n_routed_experts`` (the router's first) and adds what they give
(``ops.moe.moe_experts_held``); the other ranks' part is not computed.

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
id, pad after a row's EOS. A model with KDA layers puts each row's pads
before the prefix instead (:func:`left_pack`'s ``pads_first``): a pad is an
identity step of the recurrence, and its convolution input is zero, which
is what a row's first window sees before its first token. The prefill
writes each KDA layer's final fp32 state and the last ``kda_conv_size -
1`` convolution inputs; a step updates both in place.

A step is cut at its Python calls (K11 or K13, the router and the
experts, the LM head) into 2 x layers + 1 segments (:func:`_step_in`,
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
``ops.moe.moe_experts``, ``ops.moe.moe_experts_held``,
``ops.mla.mla_decode_attention``, ``ops.kda.kda_prefill`` and
``ops.kda.kda_decode``. Under ``train/profiling``: spans
``mpr.lm.prefill``, ``mpr.lm.decode`` and in it the greedy loop's (prefix
``lm``), ``mpr.moe.route``, ``mpr.moe.experts``, ``mpr.mla.decode``,
``mpr.kda.prefill`` and ``mpr.kda.decode``; counters ``lm.prefill_tokens``
(the rows' valid tokens, read from the device only while spans are on),
``moe.rows`` and ``moe.rows_wgmma`` (those of the rows that K10's 128-row
``wgmma`` kernels take), ``moe.rows_held`` (those of the rows routed to
experts held here: from the shapes with every expert held, else summed on
the device),
``kda.tokens`` (the valid (token, KDA layer) passes through K12, summed
on the device) and ``kda.state_bytes`` (the recurrent and convolution
state a prefill's rows hold, added a prefill). A wrapper on anything
inside a segment runs only at capture.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.models import greedy
from multimodalpromptretrieval_tpu_torch.ops import graphs, kda, mla, moe
from multimodalpromptretrieval_tpu_torch.ops.layers import (dense, param,
                                                            uniform_param)
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
    # Kimi-Linear: layers (numbered from 1) of KDA, the rest MLA; the KDA
    # widths; MLA without rotation; the expert-parallel deployment whose
    # rank 0 this model holds
    kda_layers: Tuple[int, ...] = ()
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    kda_conv_size: int = 4
    mla_use_nope: bool = False
    ep_size: int = 1
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
        n = self.num_hidden_layers
        if any(not 1 <= i <= n for i in self.kda_layers) or len(
                set(self.kda_layers)) != len(self.kda_layers):
            raise ValueError(f"LMConfig: kda_layers {self.kda_layers} are not "
                             f"distinct layers of 1 .. {n}")
        if self.num_experts_per_tok > self.router_width:
            raise ValueError("LMConfig: more experts a token than the router "
                             "scores")

    def kind(self, i: int) -> str:
        """``"kda"`` or ``"mla"``: the attention of layer ``i`` (from 0)."""
        return "kda" if i + 1 in self.kda_layers else "mla"

    def slot(self, i: int) -> int:
        """Layer ``i``'s place among the layers of its kind (its state's)."""
        return self._slots[i]

    @functools.cached_property
    def _slots(self) -> Tuple[int, ...]:
        kinds = [self.kind(i) for i in range(self.num_hidden_layers)]
        return tuple(kinds[:i].count(kinds[i]) for i in range(len(kinds)))

    @property
    def n_kda(self) -> int:
        return len(self.kda_layers)

    @property
    def n_mla(self) -> int:
        return self.num_hidden_layers - self.n_kda

    @property
    def kda_width(self) -> int:
        """q, k and v each: heads x head width."""
        return self.kda_num_heads * self.kda_head_dim

    @property
    def router_width(self) -> int:
        """The experts the router scores: every rank's."""
        return self.n_routed_experts * self.ep_size

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
        keys ignored), in DeepSeek's names or Kimi-Linear's
        (:data:`KIMI_LINEAR_KEYS`, ``linear_attn_config``); a key given in
        both with two values, or a grouped top-k over more than one group,
        raises."""
        d = dict(d)
        for theirs, ours in KIMI_LINEAR_KEYS.items():
            if theirs not in d:
                continue
            value = d.pop(theirs)
            if ours in d and d[ours] != value:
                raise ValueError(f"LMConfig: {theirs}={value!r} and {ours}="
                                 f"{d[ours]!r} disagree")
            d[ours] = value
        if d.pop("use_grouped_topk", False) and d.get("n_group", 1) != 1:
            raise ValueError("LMConfig: a grouped top-k over "
                             f"{d['n_group']} groups is not supported")
        linear = d.pop("linear_attn_config", None)
        if linear:
            kda_layers = tuple(int(i) for i in linear["kda_layers"])
            full = set(linear.get("full_attn_layers", ()))
            n = d.get("num_hidden_layers", LMConfig.num_hidden_layers)
            if full and full | set(kda_layers) != set(range(1, n + 1)) or (
                    full & set(kda_layers)):
                raise ValueError("LMConfig: linear_attn_config's kda_layers "
                                 "and full_attn_layers do not split the "
                                 f"{n} layers")
            d.update(kda_layers=kda_layers,
                     kda_num_heads=linear["num_heads"],
                     kda_head_dim=linear["head_dim"],
                     kda_conv_size=linear["short_conv_kernel_size"])
        elif "kda_layers" in d:
            d["kda_layers"] = tuple(d["kda_layers"])
        names = {f.name for f in dataclasses.fields(LMConfig)}
        return LMConfig(**{k: v for k, v in d.items() if k in names})


# Kimi-Linear's config.json names -> LMConfig's (DeepSeek's)
KIMI_LINEAR_KEYS = {
    "num_experts": "n_routed_experts",
    "num_experts_per_token": "num_experts_per_tok",
    "num_shared_experts": "n_shared_experts",
    "moe_router_activation_func": "scoring_func",
    "moe_renormalize": "norm_topk_prob",
    "num_expert_group": "n_group",
}


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
    """One block's weights, torch (out, in) layout. MLA: ``q`` rows per
    head [nope | pe], ``kva`` [c | k_pe], ``kvb`` rows per head [k_nope |
    v]. KDA: ``qkv`` [q; k; v] rows per head, ``conv`` (3 x width, taps)
    the depthwise taps (oldest first), ``fgb`` [f_a; g_a; b] (head width,
    head width, heads), ``f_b`` / ``g_b``, ``A_log`` (heads) and
    ``dt_bias`` (width) fp32, ``o_norm``. ``gate_up`` / ``experts_gate_up``
    / ``shared_gate_up`` [gate; up]; ``router`` rows: every rank's
    experts."""

    def __init__(self, cfg: LMConfig, dense_ffn: bool,
                 generator: Optional[torch.Generator], kind: str = "mla"):
        super().__init__()
        d, H, s = cfg.hidden_size, cfg.num_attention_heads, cfg.init_std
        self.attn_norm = param((d,), generator, fill=1.0)
        if kind == "kda":
            self._kda(cfg, generator)
        else:
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
            self.router = param((cfg.router_width, d), generator, std=s)
            self.router_bias = param((cfg.router_width,), generator, std=s)
            self.experts_gate_up = param((E, 2 * w, d), generator, std=s)
            self.experts_down = param((E, d, w), generator, std=s)
            self.shared_gate_up = param((2 * cfg.shared_width, d), generator,
                                        std=s)
            self.shared_down = param((d, cfg.shared_width), generator, std=s)

    def _kda(self, cfg: LMConfig, generator: Optional[torch.Generator]):
        """The KDA weights, drawn as fla's ``KimiDeltaAttention`` inits
        them: ``A_log = log U(1, 16)``, ``dt_bias = softplus^-1(dt)`` with
        ``dt`` log-uniform in [1e-3, 1e-1], the taps as ``nn.Conv1d``'s
        default (U(+-taps^-0.5)); matrices N(0, init_std^2)."""
        d, s = cfg.hidden_size, cfg.init_std
        Hk, Dk, W = cfg.kda_num_heads, cfg.kda_head_dim, cfg.kda_width
        self.qkv = param((3 * W, d), generator, std=s)
        self.conv = uniform_param((3 * W, cfg.kda_conv_size),
                                  cfg.kda_conv_size ** -0.5, generator)
        self.fgb = param((2 * Dk + Hk, d), generator, std=s)
        self.f_b = param((W, Dk), generator, std=s)
        self.g_b = param((W, Dk), generator, std=s)
        self.A_log = param((Hk,), generator)
        self.dt_bias = param((W,), generator)
        if generator is not None:
            with torch.no_grad():
                self.A_log.copy_(torch.log(1 + 15 * torch.rand(
                    Hk, generator=generator)))
                dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
                    W, generator=generator)).clamp(min=1e-4)
                self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.o_norm = param((Dk,), generator, fill=1.0)
        self.o = param((d, W), generator, std=s)


class MoELM(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm``, the untied ``head``
    (V, d). ``generator=None`` leaves the weights to be filled."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, V = cfg.hidden_size, cfg.vocab_size
        self.embed = param((V, d), generator, std=cfg.init_std)
        self.layers = nn.ModuleList(
            LMLayer(cfg, i < cfg.first_k_dense_replace, generator,
                    cfg.kind(i))
            for i in range(cfg.num_hidden_layers))
        self.final_norm = param((d,), generator, fill=1.0)
        self.head = param((V, d), generator, std=cfg.init_std)


# weights held in fp32 whatever the compute dtype: the correction biases
# decide near ties of the fp32 router; the KDA decay's parameters set a
# per-channel forgetting rate that bf16 would move by up to 3%
FP32_WEIGHTS = ("router_bias", "A_log", "dt_bias")


def hold_in(lm: MoELM, dtype: torch.dtype) -> MoELM:
    """Cast the LM's weights to ``dtype`` in place (but
    :data:`FP32_WEIGHTS`)."""
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if not name.endswith(FP32_WEIGHTS) and p.dtype != dtype:
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
    N the rows of ``h``; with ``ep_size`` > 1 only the held experts'
    part."""
    with profiling.span("mpr.moe.route"):
        idx, w = moe.route(h, p.router, p.router_bias,
                           cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                           cfg.norm_topk_prob)
    h2 = h.reshape(-1, h.shape[-1])
    k, routed = cfg.num_experts_per_tok, cfg.router_width
    rows = h2.shape[0] * k
    profiling.count("moe.rows", rows)
    if h2.is_cuda and moe.block_m(
            h2.dtype, rows / routed) == moe.BLOCK_M_MANY:
        profiling.count("moe.rows_wgmma", rows)
    idx, w = idx.reshape(-1, k), w.reshape(-1, k)
    if cfg.ep_size == 1:  # every expert held
        profiling.count("moe.rows_held", rows)
        with profiling.span("mpr.moe.experts"):
            return moe.moe_experts(h2, idx, w, p.experts_gate_up,
                                   p.experts_down)
    if profiling.enabled():
        profiling.count("moe.rows_held",
                        (idx < cfg.n_routed_experts).sum())
    with profiling.span("mpr.moe.experts"):
        return moe.moe_experts_held(h2, idx, w, p.experts_gate_up,
                                    p.experts_down, 0, routed)


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
    """q_nope, q_pe (..., H, ·), normed c and k_pe (..., ·); the pe parts
    roped (not with ``mla_use_nope``)."""
    H = cfg.num_attention_heads
    q = dense(h, p.q).unflatten(-1, (H, cfg.qk_head_dim))
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    kva = dense(h, p.kva)
    c = _rms(kva[..., :cfg.kv_lora_rank], p.kv_norm, cfg.rms_norm_eps)
    k_pe = kva[..., cfg.kv_lora_rank:]
    if cfg.mla_use_nope:
        return q_nope, q_pe, c, k_pe
    k_pe = _rope(k_pe, cos, sin)
    q_pe = _rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))
    return q_nope, q_pe, c, k_pe


def _kda_gates(p: LMLayer, cfg: LMConfig, h: torch.Tensor):
    """KDA's gates of ``h`` (..., d): the log-decay ``g`` (..., Hk, Dk)
    fp32, ``beta`` (..., Hk) fp32, and the output gate's input (..., Hk,
    Dk)."""
    Hk, Dk = cfg.kda_num_heads, cfg.kda_head_dim
    fa, ga, b = dense(h, p.fgb).split([Dk, Dk, Hk], -1)
    g = torch.nn.functional.softplus(dense(fa, p.f_b).float() + p.dt_bias)
    g = -p.A_log.float().exp()[:, None] * g.unflatten(-1, (Hk, Dk))
    return (g, torch.sigmoid(b.float()),
            dense(ga, p.g_b).unflatten(-1, (Hk, Dk)))


def _kda_out(p: LMLayer, cfg: LMConfig, o: torch.Tensor,
             gate: torch.Tensor) -> torch.Tensor:
    """``W_o (RMSNorm(o) * w * sigmoid(gate))``, o and gate (..., Hk,
    Dk)."""
    y = _rms(o, p.o_norm, cfg.rms_norm_eps).float() * torch.sigmoid(
        gate.float())
    return dense(y.to(o.dtype).flatten(-2), p.o)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


class DecodeState:
    """What the steps of a decode write in place, made outside inference
    mode (a set of graphs outlives a server's call): the latent ``cache``
    of the MLA layers (n_mla, B, T, kv_lora_rank + rope) in the compute
    dtype; the KDA layers' recurrent ``kda`` state (n_kda, B, Hk, Dk, Dk)
    fp32 and ``conv`` state, their last conv_size - 1 convolution inputs
    (n_kda, B, conv_size - 1, 3 x width) in the compute dtype; each row's
    valid length (``lengths``, the next position), the next column to
    write on the device (``column``, (1,)), the prefill's columns on the
    host (``col``), the step's ``tokens`` (B,), and the fixed targets the
    segments read of the calls between them: K11's output ``o_lat`` (B, H,
    kv_lora_rank), K13's ``o_kda`` (B, Hk, Dk) and the routed experts' sum
    ``experts`` (B, d) fp32. The (B, T) valid-key flags are the call's own
    (``key_ok``), not state."""

    def __init__(self, cfg: LMConfig, B: int, T: int, dtype, device):
        with torch.inference_mode(False):
            self.cache = torch.empty((cfg.n_mla, B, T, cfg.cache_width),
                                     dtype=dtype, device=device)
            self.lengths = torch.zeros((B,), dtype=torch.long, device=device)
            self.column = torch.zeros((1,), dtype=torch.long, device=device)
            self.tokens = torch.zeros((B,), dtype=torch.long, device=device)
            self.o_lat = torch.empty((B, cfg.num_attention_heads,
                                      cfg.kv_lora_rank), dtype=dtype,
                                     device=device)
            self.experts = torch.empty((B, cfg.hidden_size),
                                       dtype=torch.float32, device=device)
            if cfg.n_kda:
                Hk, Dk = cfg.kda_num_heads, cfg.kda_head_dim
                self.kda = torch.empty((cfg.n_kda, B, Hk, Dk, Dk),
                                       dtype=torch.float32, device=device)
                self.conv = torch.empty((cfg.n_kda, B, cfg.kda_conv_size - 1,
                                         3 * cfg.kda_width), dtype=dtype,
                                        device=device)
                self.o_kda = torch.empty((B, Hk, Dk), dtype=dtype,
                                         device=device)
        self.col = 0

    def kda_bytes(self) -> int:
        """Bytes of the recurrent and convolution state held."""
        if not hasattr(self, "kda"):
            return 0
        return (self.kda.numel() * self.kda.element_size()
                + self.conv.numel() * self.conv.element_size())


def left_pack(embed: torch.Tensor, prefix: Optional[torch.Tensor],
              input_ids: torch.Tensor, text_mask: torch.Tensor,
              pad_id: int, pads_first: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(embeds (B, P + W, d), valid (B, P + W) bool): the prefix, then the
    right-padded prompt moved to the right end of its W columns; with
    ``pads_first`` the pads before the prefix instead ([pads || prefix ||
    prompt])."""
    B, W = input_ids.shape
    n = text_mask.long().sum(dim=1)
    if pads_first and prefix is not None:
        P = prefix.shape[1]
        x = torch.cat([prefix.to(embed.dtype), embed[input_ids.long()]],
                      dim=1)
        src = (torch.arange(P + W, device=input_ids.device)[None, :]
               - (W - n)[:, None])
        ok = src >= 0
        x = x.gather(1, src.clamp(min=0)[..., None].expand(-1, -1,
                                                            x.shape[-1]))
        return torch.where(ok[..., None], x, embed[pad_id]), ok
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
    ``key_ok``'s first L columns, and each KDA layer's state; the last
    column's logits (B, V)."""
    with profiling.span("mpr.lm.prefill"):
        if profiling.enabled():
            profiling.count("lm.prefill_tokens", int(valid.sum()))
        B, L, _ = embeds.shape
        H, R = cfg.num_attention_heads, cfg.qk_rope_head_dim
        cos = sin = None
        if not cfg.mla_use_nope:
            pos = (valid.long().cumsum(dim=1) - 1).clamp(min=0)
            cos, sin = rope_tables(pos, R, cfg.rope_theta)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=valid.device).tril()
        allowed = (valid[:, None, None, :] & causal)  # (B, 1, L, L)
        if cfg.n_kda:  # pads first: a pad's query sees itself, no NaN
            allowed = allowed | torch.eye(L, dtype=torch.bool,
                                          device=valid.device)
        scale = cfg.qk_head_dim ** -0.5

        def mla_attend(i):
            def run(p: LMLayer, h: torch.Tensor) -> torch.Tensor:
                q_nope, q_pe, c, k_pe = _project(p, cfg, h, cos, sin)
                cache = state.cache[cfg.slot(i)]
                cache[:, :L, :cfg.kv_lora_rank] = c
                cache[:, :L, cfg.kv_lora_rank:] = k_pe
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

        def kda_attend(i):
            def run(p: LMLayer, h: torch.Tensor) -> torch.Tensor:
                j, Hk, Dk = cfg.slot(i), cfg.kda_num_heads, cfg.kda_head_dim
                pre = dense(h, p.qkv)
                W = cfg.kda_conv_size - 1
                state.conv[j] = torch.nn.functional.pad(
                    pre[:, -W:] * valid[:, -W:, None].to(pre.dtype),
                    (0, 0, max(W - L, 0), 0))
                q, k, v = pre.view(B, L, 3, Hk, Dk).unbind(2)
                g, beta, gate = _kda_gates(p, cfg, h)
                with profiling.span("mpr.kda.prefill"):
                    o = kda.kda_prefill(q, k, v, g, beta, valid,
                                        state.kda[j], Dk ** -0.5, p.conv)
                return _kda_out(p, cfg, o, gate)
            return run

        if cfg.n_kda and profiling.enabled():
            profiling.count("kda.tokens", valid.sum() * cfg.n_kda)
            profiling.count("kda.state_bytes", state.kda_bytes())
        x = embeds
        for i, p in enumerate(params.layers):
            attend = kda_attend if cfg.kind(i) == "kda" else mla_attend
            x = _block(p, cfg, i, x, attend(i))
        key_ok[:, :L] = valid.to(torch.int8)
        state.lengths.copy_(valid.long().sum(dim=1))
        state.column.fill_(L)
        state.col = L
        h = _rms(x[:, -1], params.final_norm, cfg.rms_norm_eps)
        return lm_head(h, params.head)


def _step_in(params: MoELM, cfg: LMConfig, st: DecodeState, i: int, prev,
             rope):
    """The segment before layer ``i``'s attention call: the embedding of
    the step's tokens and the rope tables at the rows' positions (``i`` 0;
    none with ``mla_use_nope``), or the rest of layer ``i - 1``
    (:func:`_ffn_rest` of ``prev``); then ``attn_norm`` and, for MLA, the
    projections, c and k_pe written into the cache at the step's column
    and the absorbed query ``q_lat = q_nope W_UK``; for KDA, the
    projections, the convolution over the state's last inputs and this
    one (which it keeps), and the gates. -> (x, what the segment after the
    call reads (None, or the output gate's input), cos, sin, then the
    call's inputs, contiguous: q_lat, q_pe or q, k, v, g, beta); flat, as
    a graph keeps its outputs."""
    if i == 0:
        x = params.embed[st.tokens]
        rope = (None, None) if cfg.mla_use_nope else rope_tables(
            st.lengths, cfg.qk_rope_head_dim, cfg.rope_theta)
    else:
        x = _ffn_rest(params.layers[i - 1], st, *prev)
    p = params.layers[i]
    h = _rms(x, p.attn_norm, cfg.rms_norm_eps)
    if cfg.kind(i) == "kda":
        j, Hk, Dk = cfg.slot(i), cfg.kda_num_heads, cfg.kda_head_dim
        win = torch.cat([st.conv[j], dense(h, p.qkv)[:, None]], dim=1)
        st.conv[j].copy_(win[:, 1:])
        y = torch.nn.functional.silu(
            (win.float() * p.conv.t().float()).sum(dim=1)).to(x.dtype)
        q, k, v = (t.contiguous() for t in y.view(-1, 3, Hk, Dk).unbind(1))
        g, beta, gate = _kda_gates(p, cfg, h)
        return (x, gate) + tuple(rope) + (q, k, v, g, beta)
    H, C, nope = cfg.num_attention_heads, cfg.kv_lora_rank, \
        cfg.qk_nope_head_dim
    q_nope, q_pe, c, k_pe = _project(p, cfg, h, *rope)
    cache = st.cache[cfg.slot(i)]
    cache[..., :C].index_copy_(1, st.column, c[:, None])
    cache[..., C:].index_copy_(1, st.column, k_pe[:, None])
    w_uk = p.kvb.view(H, nope + cfg.v_head_dim, C)[:, :nope]
    # (H, B, nope) @ (H, nope, C): the absorbed query
    q_lat = torch.bmm(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
    return (x, None) + tuple(rope) + (q_lat.contiguous(), q_pe.contiguous())


def _step_mid(params: MoELM, cfg: LMConfig, st: DecodeState, i: int,
              x: torch.Tensor, gate: Optional[torch.Tensor]):
    """The segment after layer ``i``'s attention call: ``W_UV`` and ``W_o``
    over K11's output (``st.o_lat``), or the gated norm and ``W_o`` over
    K13's (``st.o_kda``, ``gate``); the residual add and ``ffn_norm``; on
    a MoE layer also the shared experts' MLP, which reads only the normed
    h. -> (x, h), or (x, h, shared)."""
    p = params.layers[i]
    if cfg.kind(i) == "kda":
        x = x + _kda_out(p, cfg, st.o_kda, gate)
    else:
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


def _attention_call(cfg: LMConfig, st: DecodeState, i: int, args,
                    key_ok: torch.Tensor, length: int) -> None:
    """Layer ``i``'s attention kernel between its segments, into the
    state's fixed target: K11 over ``length`` columns of the latent cache,
    or K13 on the layer's recurrent state."""
    if cfg.kind(i) == "kda":
        with profiling.span("mpr.kda.decode"):
            kda.kda_decode(*args, st.kda[cfg.slot(i)],
                           cfg.kda_head_dim ** -0.5, out=st.o_kda)
        return
    with profiling.span("mpr.mla.decode"):
        o_lat = mla.mla_decode_attention(
            *args, st.cache[cfg.slot(i)], key_ok, length,
            cfg.qk_head_dim ** -0.5)
    st.o_lat.copy_(o_lat)


def _decode_step(params: MoELM, cfg: LMConfig, st: DecodeState,
                 key_ok: torch.Tensor, length: int, run) -> torch.Tensor:
    """One step through the 2 x layers + 1 segments in order, each run by
    ``run(i, fn, *args)``. Between them the attention kernel (K11 over
    ``length`` columns, or K13) and, on a MoE layer, the router and the
    experts, their outputs in the state's fixed targets; none of them runs
    while ``run.capturing``. -> the LM head's input."""
    n = cfg.num_hidden_layers
    x, gate, cos, sin, *args = run(0, _step_in, params, cfg, st, 0, None,
                                   None)
    for i, p in enumerate(params.layers):
        if not run.capturing:
            _attention_call(cfg, st, i, args, key_ok, length)
        prev = run(2 * i + 1, _step_mid, params, cfg, st, i, x, gate)
        if not run.capturing and i >= cfg.first_k_dense_replace:
            st.experts.copy_(_routed(p, cfg, prev[1]))
        if i + 1 < n:
            x, gate, _, _, *args = run(2 * i + 2, _step_in, params, cfg,
                                       st, i + 1, prev, (cos, sin))
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
                              cfg.pad_token_id, pads_first=cfg.n_kda > 0)
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
