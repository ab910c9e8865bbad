"""The work the Kimi-Linear configurations' inputs need: operations and
bytes, from shapes, in the conventions of ``portbench/work.py`` and
``portbench/work_lm.py`` (2 * m * k * n a product, only products counted,
every row at its unpadded length, each input byte read once and each
output byte written once), whatever implements them:

* the KDA decode step (:func:`kda_decode_work`): per (row, head) the
  products S^T k, k u^T and S^T q over the (K, V) state; the state read
  and written once (fp32), q / k / v and o once, g (fp32, a channel) and
  beta (fp32) once;
* the KDA prefill (:func:`kda_prefill_work`): the short convolutions of q
  / k / v (W taps a channel), then the chunked form
  over each row's valid tokens in chunks of 64: the pairwise products of A
  (j < r) and P (j <= r), the forward substitution, P U, and the three
  products with the (K, V) state; q / k / v / g / beta in and o out once
  a valid token, the taps once, the final state written once (a fresh row
  reads none);
* the held expert share (:func:`moe_held_work`): ``work_lm``'s routed
  experts over the rows routed to held experts and the held experts they
  touch;
* the whole model (:func:`lm_prefill_flops`, :func:`lm_decode_flops`):
  the projections, the dense layer, the held experts (``work_lm``'s
  per-token products at k x held share rows a token), the shared expert,
  the router, the KDA layers' chunked / recurrent products, the MLA
  layers' non-absorbed prefill and absorbed steps, and the head.

Configurations are plain dicts with the published ``config.json`` keys
(``portbench/configs/kimi-linear-48b-a3b_ep4_vit-b32.json``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from portbench import work_lm

CHUNK = 64


def _mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def kda_decode_work(rows: int, heads: int, K: int, V: int,
                    itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of one decode call over ``rows`` x ``heads``."""
    n = float(rows * heads)
    flops = n * 3 * _mm(1, K, V)
    nbytes = n * (2 * K * V * 4 + (2 * K + 2 * V) * itemsize + K * 4 + 4)
    return flops, nbytes


def _chunks(n: int) -> list:
    return [min(CHUNK, n - s) for s in range(0, n, CHUNK)]


def kda_prefill_work(valid: Sequence[int], heads: int, K: int, V: int,
                     itemsize: int, taps: int) -> Tuple[float, float]:
    """(operations, bytes) of one prefill call: ``valid[b]`` valid tokens
    in row b, a fresh state a row; ``taps`` a channel of the convolutions
    it applies first."""
    flops = float(sum(valid)) * heads * (2 * K + V) * 2.0 * taps
    nbytes = float(heads * (2 * K + V) * taps * itemsize)
    for n in valid:
        for c in _chunks(int(n)):
            strict, incl = c * (c - 1) / 2, c * (c + 1) / 2
            flops += heads * (2.0 * K * (strict + incl)  # A, P
                              + 2.0 * V * (strict + incl)  # solve, P U
                              + 3 * _mm(c, K, V))  # the state products
        nbytes += heads * (n * ((2 * K + 2 * V) * itemsize + K * 4 + 4)
                           + K * V * 4)
    return flops, nbytes


def moe_held_work(d: int, width: int, idx: torch.Tensor, first: int,
                  held: int, itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of a held share's call: the rows of ``idx``
    routed to experts ``first`` .. ``first + held - 1``."""
    local = idx.reshape(-1) - first
    mine = local[(local >= 0) & (local < held)]
    return work_lm.moe_experts_work(d, width, int(mine.numel()),
                                    int(torch.unique(mine).numel()),
                                    itemsize)


def _kinds(cfg: dict):
    kda = set(cfg["linear_attn_config"]["kda_layers"])
    return ["kda" if i + 1 in kda else "mla"
            for i in range(cfg["num_hidden_layers"])]


def _held_share(cfg: dict) -> float:
    return 1.0 / cfg.get("ep_size", 1)


def _layer_token(cfg: dict, kind: str, dense: bool) -> float:
    """A token's products in one layer outside the attention's own mixing
    (scores, recurrence): the projections and the FFN."""
    d = cfg["hidden_size"]
    lin = cfg["linear_attn_config"]
    if kind == "kda":
        Hk, Dk = lin["num_heads"], lin["head_dim"]
        W = Hk * Dk
        total = (_mm(1, d, 3 * W) + _mm(1, d, 2 * Dk + Hk)
                 + 2 * _mm(1, Dk, W) + _mm(1, W, d))
    else:
        H = cfg["num_attention_heads"]
        dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
        total = (_mm(1, d, H * (dn + dr)) + _mm(1, d, cfg["kv_lora_rank"]
                                                + dr) + _mm(1, H * dv, d))
    if dense:
        return total + 3 * _mm(1, d, cfg["intermediate_size"])
    w = cfg["moe_intermediate_size"]
    routed = cfg["num_experts"] * cfg.get("ep_size", 1)
    return (total + _mm(1, d, routed)
            + cfg["num_experts_per_token"] * _held_share(cfg) * 3
            * _mm(1, d, w)
            + 3 * _mm(1, d, cfg["num_shared_experts"] * w))


def _per_token(cfg: dict) -> float:
    return sum(_layer_token(cfg, kind, i < cfg["first_k_dense_replace"])
               for i, kind in enumerate(_kinds(cfg)))


def lm_prefill_flops(cfg: dict, lengths: Sequence[int]) -> float:
    """The prefill over rows of ``lengths`` valid tokens (prefix and
    prompt): MLA non-absorbed over the causal pairs, KDA in the chunked
    form, the head at each row's last token."""
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    lin = cfg["linear_attn_config"]
    kinds = _kinds(cfg)
    n_mla, n_kda = kinds.count("mla"), kinds.count("kda")
    per_token = _per_token(cfg) + n_mla * _mm(1, cfg["kv_lora_rank"],
                                              H * (dn + dv))
    kda_ops, _ = kda_prefill_work(lengths, lin["num_heads"], lin["head_dim"],
                                  lin["head_dim"], 2,
                                  lin["short_conv_kernel_size"])
    total = n_kda * kda_ops
    for L in lengths:
        pairs = L * (L + 1) / 2
        total += (L * per_token + n_mla * 2.0 * pairs * H * (dn + dr + dv)
                  + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))
    return total


def lm_decode_flops(cfg: dict, lengths: Sequence[int],
                    steps: Sequence[int]) -> float:
    """The greedy steps after the prefill: per row, step s (1 ..
    ``steps - 1``): MLA absorbed over ``lengths + s`` tokens, KDA's
    recurrent step, with the head."""
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    lin = cfg["linear_attn_config"]
    kinds = _kinds(cfg)
    n_mla, n_kda = kinds.count("mla"), kinds.count("kda")
    kda_ops, _ = kda_decode_work(1, lin["num_heads"], lin["head_dim"],
                                 lin["head_dim"], 2)
    per_token = (_per_token(cfg) + n_mla * H * (_mm(1, dn, C) + _mm(1, C, dv))
                 + n_kda * kda_ops
                 + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))
    total = 0.0
    for L, S in zip(lengths, steps):
        for s in range(1, S):
            total += per_token + n_mla * 2.0 * H * (L + s) * (2 * C + dr)
    return total
