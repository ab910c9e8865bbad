"""The plain reference of the Kimi-Linear LM generator: Kimi-Linear-48B-A3B's
decoder (KDA layers beside NoPE MLA layers, a DeepSeek-V3 MoE) over one row
at a time.

Plain PyTorch in float32, written from the published description (Kimi
Linear technical report, arXiv:2510.26692, section 3: Kimi Delta Attention;
the MLA and MoE of DeepSeek-V3, Liu et al. 2024; the ``config.json`` keys of
https://huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct), with no
kernel, cache, chunking or batching of the program: every row runs alone
over its real tokens, the KDA layers as the token-by-token recurrence, the
attention in the non-absorbed form, the experts as a loop. It imports
nothing of the program and no JAX. Call it under
``reference.models.exact_fp32`` (TF32 off); under
``reference.models.products_through`` every product's operands are rounded
first (the check's fp8 control).

Per layer, x the residual stream of a row of T tokens, ``h = RMSNorm(x)``:

* KDA (layers of ``linear_attn_config.kda_layers``, numbered from 1): ``[q
  | k | v] = W_qkv h``, each channel through its causal convolution of the
  last 4 inputs (zeros before the row's first token) and SiLU; per head
  ``q, k`` L2-normalised (eps 1e-6); ``g = -exp(A_log_h) softplus(W_fb W_fa
  h + dt_bias)``, ``beta = sigmoid(W_b h)``; from S = 0, per token
  ``S = Diag(exp(g)) S; S += beta k (v - S^T k)^T; o = S^T q / sqrt(128)``;
  ``x += W_o (RMSNorm(o) * w * sigmoid(W_gb W_ga h))``, the norm per head;
* MLA (the others): as ``reference/moe_lm.py`` with no rotation (NoPE):
  ``q_pe`` and ``k_pe`` enter the scores as they are, scale 1 / sqrt(192);
* layer 1: a SiLU-gated MLP; later layers: ``reference/moe_lm.py``'s MoE
  (sigmoid router over all 256 experts, top 8 by score + bias, weights
  normalised and scaled by 2.446, one shared expert), holding the same
  share as the program: rank 0's experts of ``ep_size`` ranks (the
  router's first ``num_experts``); the others add nothing (their weights
  read as zeros);
* the final RMSNorm and the untied head.

Departures from fla's ``KimiDeltaAttention``, each stated: none in the
arithmetic; the gate projections carry no bias (Kimi-Linear's own
modeling code has none).
"""

from __future__ import annotations

import math
from typing import List, Mapping, Optional, Sequence

import torch

from portbench.reference import moe_lm as ref_lm
from portbench.reference.models import mm

_rms, _lin, _gated = ref_lm._rms, ref_lm._lin, ref_lm._gated


def layer_kinds(cfg: dict) -> List[str]:
    """``"kda"`` or ``"mla"`` for each layer (from 0)."""
    kda = set(cfg["linear_attn_config"]["kda_layers"])
    return ["kda" if i + 1 in kda else "mla"
            for i in range(cfg["num_hidden_layers"])]


def _kda(p: Mapping[str, torch.Tensor], cfg: dict, h: torch.Tensor,
         eps: float) -> torch.Tensor:
    lin = cfg["linear_attn_config"]
    H, D, W = lin["num_heads"], lin["head_dim"], lin["short_conv_kernel_size"]
    T = h.shape[0]
    pre = _lin(h, p["qkv"])  # (T, 3 H D)
    taps = p["conv"].float()  # (3 H D, W), the oldest input first
    hist = torch.cat([pre.new_zeros(W - 1, pre.shape[1]), pre])
    y = sum(hist[i:i + T] * taps[:, i] for i in range(W))
    y = torch.nn.functional.silu(y).view(T, 3, H, D)
    q, k, v = y[:, 0], y[:, 1], y[:, 2]
    q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6)
    k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
    fgb = _lin(h, p["fgb"])
    fa, ga, b = fgb[:, :D], fgb[:, D:2 * D], fgb[:, 2 * D:]
    g = -p["A_log"].float().exp()[:, None] * torch.nn.functional.softplus(
        _lin(fa, p["f_b"]) + p["dt_bias"].float()).view(T, H, D)
    beta = torch.sigmoid(b)  # (T, H)
    S = h.new_zeros(H, D, D)
    o = []
    for t in range(T):
        S = S * g[t].exp()[..., None]
        kv = mm(k[t][:, None, :], S)[:, 0]  # (H, D): S^T k
        S = S + k[t][:, :, None] * (beta[t][:, None] * (v[t] - kv))[:, None]
        o.append(mm(q[t][:, None, :], S)[:, 0] / math.sqrt(D))
    o = torch.stack(o)  # (T, H, D)
    gate = _lin(ga, p["g_b"]).view(T, H, D)
    y = _rms(o, p["o_norm"], eps) * torch.sigmoid(gate)
    return _lin(y.reshape(T, H * D), p["o"])


def _mla_nope(p: Mapping[str, torch.Tensor], cfg: dict,
              h: torch.Tensor) -> torch.Tensor:
    T = h.shape[0]
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    q = _lin(h, p["q"]).view(T, H, dn + dr)
    kva = _lin(h, p["kva"])
    c = _rms(kva[:, :C], p["kv_norm"], cfg["rms_norm_eps"])
    k_pe = kva[:, C:]
    kv = _lin(c, p["kvb"]).view(T, H, dn + dv)
    s = (mm(q[..., :dn].transpose(0, 1), kv[..., :dn].permute(1, 2, 0))
         + mm(q[..., dn:].transpose(0, 1), k_pe.t()[None]))  # (H, T, T)
    s = s / math.sqrt(dn + dr)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                 device=h.device).triu(1), float("-inf"))
    o = mm(torch.softmax(s, dim=-1), kv[..., dn:].transpose(0, 1))
    return _lin(o.transpose(0, 1).reshape(T, H * dv), p["o"])


class _Share:
    """The experts' weights as the reference's MoE indexes them: by the
    router's id, rank 0's experts (the first ids) as drawn, every other as
    zeros (an absent expert adds nothing)."""

    def __init__(self, held):
        self.held = held

    def __getitem__(self, e: int) -> torch.Tensor:
        if e < self.held.shape[0]:
            return self.held[e]
        return self.held.new_zeros(self.held.shape[1:])


_KDA = ("attn_norm", "qkv", "conv", "fgb", "f_b", "g_b", "A_log", "dt_bias",
        "o_norm", "o", "ffn_norm")
_MLA = ("attn_norm", "q", "kva", "kv_norm", "kvb", "o", "ffn_norm")


def forward_rows(w: Mapping[str, torch.Tensor], cfg: dict,
                 rows: Sequence[torch.Tensor],
                 routes: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                 route_tol: float = 0.0,
                 chosen: Optional[List[List[torch.Tensor]]] = None):
    """The final-normed hidden states (T_r, d) of each row from its input
    embeddings (T_r, d), and the routing readings, as
    ``reference/moe_lm.forward_rows`` (its ``routes``, ``route_tol`` and
    ``chosen``). ``cfg``: the published keys (Kimi-Linear's names), with
    ``ep_size``; the experts held are rank 0's."""
    stats = {"route_excess": 0, "route_flips": 0, "route_decisions": 0,
             "flip_margin": 0.0, "margins": []}
    moe_cfg = {"num_experts_per_tok": cfg["num_experts_per_token"],
               "norm_topk_prob": cfg["moe_renormalize"],
               "routed_scaling_factor": cfg["routed_scaling_factor"]}
    xs = [r.float() for r in rows]
    eps = cfg["rms_norm_eps"]
    m = 0
    for i, kind in enumerate(layer_kinds(cfg)):
        dense = i < cfg["first_k_dense_replace"]
        pre = f"lm.layers.{i}."
        names = (_KDA if kind == "kda" else _MLA) + (
            ref_lm._DENSE if dense else ref_lm._MOE)
        p = {n: w[pre + n] for n in names}
        if not dense:
            p["experts_gate_up"] = _Share(p["experts_gate_up"])
            p["experts_down"] = _Share(p["experts_down"])
        for r, x in enumerate(xs):
            h = _rms(x, p["attn_norm"], eps)
            x = x + (_kda(p, cfg, h, eps) if kind == "kda"
                     else _mla_nope(p, cfg, h))
            h = _rms(x, p["ffn_norm"], eps)
            if dense:
                xs[r] = x + _gated(h, p["gate_up"], p["down"])
            else:
                xs[r] = x + ref_lm._moe(
                    p, moe_cfg, h, None if routes is None else routes[r][m],
                    route_tol, stats, None if chosen is None else chosen[r])
        if not dense:
            m += 1
        del p
    norm = w["lm.final_norm"]
    margins = torch.cat(stats.pop("margins")) if stats["margins"] else None
    stats["margin_quantiles"] = (
        [] if margins is None or not margins.numel() else torch.quantile(
            margins.float().cpu(), torch.tensor([0.5, 0.9, 0.99, 1.0])
        ).tolist())
    return [_rms(x, norm, eps) for x in xs], stats


embed, logits = ref_lm.embed, ref_lm.logits
