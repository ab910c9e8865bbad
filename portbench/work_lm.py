"""The work the LM configurations' inputs need: operations and bytes, from
shapes, in the conventions of ``portbench/work.py`` (2 * m * k * n a
product, only products counted, every row at its unpadded length, each
input byte read once and each output byte written once), whatever
implements them:

* the routed experts (:func:`moe_experts_work`): each token's k rows
  through a SiLU-gated MLP (three products of d x I); each touched
  expert's weights read once, the rows in and the rows out once;
* the absorbed latent decode attention (:func:`mla_decode_work`): per
  head, a score against each of the row's valid keys over the latent
  and rope widths and a sum of the latent rows; each row's cache of valid
  tokens (latent + rope) read once, q (latent + rope) and the output
  (latent) once a head;
* the whole model (:func:`lm_prefill_flops`, :func:`lm_decode_flops`):
  the prefill in the non-absorbed form over each row's valid tokens (the
  causal pairs of the attention), the head at its last position; a
  decode step in the absorbed form over the row's tokens so far.

Configurations are plain dicts with the published ``config.json`` keys
(``portbench/configs/kimi-vl-a3b_vit-b32.json``).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def moe_experts_work(d: int, width: int, rows: int, touched: int,
                     itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of ``rows`` (token, expert) rows over
    ``touched`` experts of width ``width``."""
    flops = 3 * _mm(rows, d, width)
    nbytes = (touched * 3 * d * width + 2 * rows * d) * itemsize
    return flops, nbytes


def mla_decode_work(heads: int, latent: int, rope: int,
                    keys: Sequence[int], itemsize: int
                    ) -> Tuple[float, float]:
    """(operations, bytes) of one decode call: a query row a batch row,
    ``keys[b]`` valid cached tokens."""
    n = float(sum(keys))
    flops = 2.0 * heads * n * (latent + rope) + 2.0 * heads * n * latent
    nbytes = (n * (latent + rope) + len(keys) * heads * (2 * latent + rope)
              ) * itemsize
    return flops, nbytes


def _layer_token(cfg: dict, dense: bool) -> float:
    """A token's products in one layer outside the attention scores."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    total = (_mm(1, d, H * (dn + dr)) + _mm(1, d, C + dr)
             + _mm(1, H * dv, d))
    if dense:
        return total + 3 * _mm(1, d, cfg["intermediate_size"])
    w = cfg["moe_intermediate_size"]
    return (total + _mm(1, d, cfg["n_routed_experts"])
            + cfg["num_experts_per_tok"] * 3 * _mm(1, d, w)
            + 3 * _mm(1, d, cfg["n_shared_experts"] * w))


def _layers(cfg: dict) -> Tuple[int, int]:
    """(dense layers, MoE layers)."""
    n_dense = cfg["first_k_dense_replace"]
    return n_dense, cfg["num_hidden_layers"] - n_dense


def lm_prefill_flops(cfg: dict, lengths: Sequence[int]) -> float:
    """The prefill over rows of ``lengths`` valid tokens (prefix and
    prompt), non-absorbed, and the head at each row's last token."""
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    n_dense, n_moe = _layers(cfg)
    per_token = (n_dense * _layer_token(cfg, True)
                 + n_moe * _layer_token(cfg, False)
                 + cfg["num_hidden_layers"] * _mm(1, C, H * (dn + dv)))
    total = 0.0
    for L in lengths:
        pairs = L * (L + 1) / 2
        total += (L * per_token
                  + cfg["num_hidden_layers"] * 2.0 * pairs * H * (
                      dn + dr + dv)
                  + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))
    return total


def lm_decode_flops(cfg: dict, lengths: Sequence[int],
                    steps: Sequence[int]) -> float:
    """The greedy steps after the prefill: per row, step s (1 ..
    ``steps - 1``) over ``lengths + s`` tokens, absorbed, with the head."""
    H = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    C = cfg["kv_lora_rank"]
    n_dense, n_moe = _layers(cfg)
    per_token = (n_dense * _layer_token(cfg, True)
                 + n_moe * _layer_token(cfg, False)
                 + cfg["num_hidden_layers"] * (_mm(1, dn, C) * H
                                               + _mm(1, C, dv) * H)
                 + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))
    total = 0.0
    for L, S in zip(lengths, steps):
        for s in range(1, S):
            keys = L + s
            total += per_token + cfg["num_hidden_layers"] * 2.0 * H * keys * (
                2 * C + dr)
    return total
