"""The plain reference of the LM generator: DeepSeek-V3's decoder (the
Kimi-VL-A3B / Moonlight-16B-A3B language model) over one row at a time.

Plain PyTorch in float32, written from the published description
(DeepSeek-V3 technical report, Liu et al. 2024, section 2.1: multi-head
latent attention with decoupled RoPE, DeepSeekMoE with sigmoid gating and
auxiliary-loss-free bias; the ``config.json`` keys of
https://huggingface.co/moonshotai/Kimi-VL-A3B-Instruct), with no kernel,
cache or batching of the program: every row runs alone over its whole
sequence, the attention in the non-absorbed form (per-head k_nope and v
from the latent), the experts as a loop over the experts a row uses. It
imports nothing of the program and no JAX. Call it under
``reference.models.exact_fp32`` (TF32 off); under
``reference.models.products_through`` every product's operands are
rounded first (the check's fp8 control).

Weights come in by name (``lm.embed``, ``lm.layers.{i}.q``, ...;
``portbench/weights_lm.py`` lists the layout), as a mapping that may draw
each tensor when it is read: the forward reads a layer's weights once for
all rows, then lets them go.

Per layer, x the residual stream of a row of T tokens:

* ``h = RMSNorm(x)``; ``q = W_q h`` split per head [nope 128 | pe 64];
  ``[c | k_pe] = W_kva h``; ``c = RMSNorm_kv(c)``; ``[k_nope | v] = W_kvb
  c`` per head; RoPE rotates each interleaved pair (x_2i, x_2i+1) of
  ``q_pe`` and ``k_pe`` by ``p * theta^(-2i / 64)`` and writes the pair's
  two results to slots i and i + 32 (DeepSeek's layout); scores
  ``(q_nope . k_nope + q_pe . k_pe) / sqrt(192)`` over keys j <= i;
  ``x += W_o concat_h(softmax . v)``;
* layer 0: ``x += W_down(silu(W_gate h) * W_up h)``; later layers:
  ``s = sigmoid(W_r h)``, the top k of ``s + b``, ``w = s_top / sum(s_top)
  * routed_scaling_factor``, ``x += sum w_e E_e(h) + E_shared(h)``;
* the final RMSNorm and the untied head.

Departures, each stated:

* positions are 0 .. T - 1 over the row's real tokens: the program's
  left padding and its positions from the mask give the same;
* ``route``: where the program chose an expert that this reference ranks
  below its own k-th (by ``s + b``) by at most ``route_tol``, the token
  and layer take the program's experts (weighted by this reference's
  scores), so that the logits compare like with like; a choice further
  below counts in ``route_excess`` and the reference keeps its own. The
  flips taken are counted (the check compares their share), and the
  quantiles of how far below the reference's k-th each differing choice
  lies are read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from portbench.reference.models import mm


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w.float() * (x / torch.sqrt(x.pow(2).mean(-1, keepdim=True)
                                       + eps))


def _lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mm(x, w.float().t())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, ..., R) rotated pairwise by position (axis 0)."""
    T, R = x.shape[0], x.shape[-1]
    i = torch.arange(R // 2, device=x.device, dtype=torch.float64)
    ang = (torch.arange(T, device=x.device, dtype=torch.float64)[:, None]
           * theta ** (-2.0 * i / R)).float()
    shape = (T,) + (1,) * (x.dim() - 2) + (R // 2,)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(p: Dict[str, torch.Tensor], cfg: dict,
               h: torch.Tensor) -> torch.Tensor:
    T = h.shape[0]
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    q = _lin(h, p["q"]).view(T, H, dn + dr)
    q_nope, q_pe = q[..., :dn], _rope(q[..., dn:], cfg["rope_theta"])
    kva = _lin(h, p["kva"])
    c = _rms(kva[:, :C], p["kv_norm"], cfg["rms_norm_eps"])
    k_pe = _rope(kva[:, C:], cfg["rope_theta"])  # (T, dr), every head's
    kv = _lin(c, p["kvb"]).view(T, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    s = (mm(q_nope.transpose(0, 1), k_nope.permute(1, 2, 0))
         + mm(q_pe.transpose(0, 1), k_pe.t()[None]))  # (H, T, T)
    s = s / math.sqrt(dn + dr)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                 device=h.device).triu(1), float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v.transpose(0, 1))  # (H, T, dv)
    return _lin(o.transpose(0, 1).reshape(T, H * dv), p["o"])


def _gated(h: torch.Tensor, gate_up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    w = gate_up.float()
    half = w.shape[0] // 2
    g, u = _lin(h, w[:half]), _lin(h, w[half:])
    return _lin(torch.nn.functional.silu(g) * u, down)


def _moe(p: Dict[str, torch.Tensor], cfg: dict, h: torch.Tensor,
         program: Optional[torch.Tensor], route_tol: float, stats: dict,
         chosen: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """The routed experts plus the shared ones over a row's tokens (T,
    d). ``program``: the program's experts (T, k) to judge and, within
    ``route_tol``, take; ``chosen`` collects the experts used."""
    k = cfg["num_experts_per_tok"]
    s = torch.sigmoid(_lin(h, p["router"]))  # (T, E)
    ranked = s + p["router_bias"].float()
    own = torch.topk(ranked, k, dim=-1).indices
    sel = own.clone()
    if program is not None:
        kth = ranked.gather(1, own).min(dim=1).values
        below = (kth[:, None] - ranked.gather(1, program.long())).clamp(
            min=0).amax(dim=1)
        same = (torch.sort(own, dim=1).values
                == torch.sort(program.long(), dim=1).values).all(dim=1)
        excess = below > route_tol
        flip = ~same & ~excess
        stats["route_excess"] += int(excess.sum())
        stats["route_flips"] += int(flip.sum())
        stats["route_decisions"] += int(own.shape[0])
        stats["margins"].append(below[~same])
        if bool(flip.any()):
            stats["flip_margin"] = max(stats["flip_margin"],
                                       float(below[flip].max()))
        sel = torch.where(flip[:, None], program.long(), own)
    if chosen is not None:
        chosen.append(sel)
    w = s.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=1, keepdim=True)
    w = w * cfg["routed_scaling_factor"]
    out = _gated(h, p["shared_gate_up"], p["shared_down"])
    gate_up, down = p["experts_gate_up"], p["experts_down"]
    for e in torch.unique(sel).tolist():
        tok, slot = torch.nonzero(sel == e, as_tuple=True)
        y = _gated(h[tok], gate_up[e], down[e])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out


_ATTN = ("attn_norm", "q", "kva", "kv_norm", "kvb", "o", "ffn_norm")
_DENSE = ("gate_up", "down")
_MOE = ("router", "router_bias", "experts_gate_up", "experts_down",
        "shared_gate_up", "shared_down")


def forward_rows(w: Mapping[str, torch.Tensor], cfg: dict,
                 rows: Sequence[torch.Tensor],
                 routes: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                 route_tol: float = 0.0,
                 chosen: Optional[List[List[torch.Tensor]]] = None):
    """The final-normed hidden states (T_r, d) of each row, from its input
    embeddings (T_r, d) (the visual prefix, then the token embeddings), and
    the routing readings. ``routes[r][m]``: the program's experts (T_r, k)
    of row r at its m-th MoE layer, judged and taken within ``route_tol``
    (module docstring); ``chosen[r]`` collects the experts this forward
    used, in the same layout."""
    stats = {"route_excess": 0, "route_flips": 0, "route_decisions": 0,
             "flip_margin": 0.0, "margins": []}
    xs = [r.float() for r in rows]
    eps = cfg["rms_norm_eps"]
    m = 0
    for i in range(cfg["num_hidden_layers"]):
        dense = i < cfg["first_k_dense_replace"]
        pre = f"lm.layers.{i}."
        p = {n: w[pre + n] for n in _ATTN + (_DENSE if dense else _MOE)}
        for r, x in enumerate(xs):
            x = x + _attention(p, cfg, _rms(x, p["attn_norm"], eps))
            h = _rms(x, p["ffn_norm"], eps)
            if dense:
                xs[r] = x + _gated(h, p["gate_up"], p["down"])
            else:
                xs[r] = x + _moe(p, cfg, h,
                                 None if routes is None else routes[r][m],
                                 route_tol, stats,
                                 None if chosen is None else chosen[r])
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


def embed(w: Mapping[str, torch.Tensor], ids: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """Token embeddings of each row's ids."""
    table = w["lm.embed"]
    return [table[i.long()].float() for i in ids]


def logits(w: Mapping[str, torch.Tensor], hidden: torch.Tensor
           ) -> torch.Tensor:
    """The untied head over (n, d) final states: (n, V)."""
    return _lin(hidden, w["lm.head"])
