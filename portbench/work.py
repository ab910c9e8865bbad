"""The work the inputs need: operations and bytes, from shapes.

Derived from ``multimodalpromptretrieval_tpu_torch/ops/flops.py`` (the
2 * m * k * n convention; only products are counted: norms, softmax,
residuals and biases are elementwise) and ``chip_smoke.attention_work``,
corrected to count what the inputs need rather than what the program
does:

* every sequence at its own unpadded length (a prompt's mask, a CLIP text
  row up to its EOT token), not at the padded bucket width;
* decode step ``t`` attends over the ``t + 1`` tokens decoded so far, not
  over the whole cache, and a row stops at its EOS;
* a kernel reads each input byte once and writes each output byte once.

So a later change that stops doing padded or masked work does not lower the
share it is judged by. Configurations are the plain dicts of
``portbench/configs/<name>.json`` (``t5`` and ``clip`` groups).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def _mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def _ff(t5: dict, rows: float) -> float:
    n = 3 if t5.get("feed_forward_proj") == "gated-gelu" else 2
    return n * _mm(rows, t5["d_model"], t5["d_ff"])


def _clip_layers(rows_len: Iterable[int], width: int, layers: int,
                 causal: bool) -> float:
    """A CLIP residual stack over rows of the given lengths: q/k/v/o, the
    attention products over the keys each query may see, the 4x MLP."""
    total = 0.0
    for L in rows_len:
        pairs = L * (L + 1) / 2 if causal else L * L
        total += (_mm(L, width, 4 * width) + 2 * 2.0 * pairs * width
                  + _mm(L, width, 4 * width) + _mm(L, 4 * width, width))
    return layers * total


def vit_flops(clip: dict, n_images: int, proj_out: int = 0) -> float:
    """The ViT over ``n_images`` images: patch embedding, the stack over
    1 + grid^2 tokens, the projection of every token (all of them are the
    T5 prefix), and the optional projection to T5's width."""
    grid = clip["image_resolution"] // clip["patch_size"]
    L, w = grid * grid + 1, clip["vision_width"]
    per = _mm(L - 1, 3 * clip["patch_size"] ** 2, w)
    per += _clip_layers([L], w, clip["vision_layers"], causal=False)
    per += _mm(L, w, clip["embed_dim"])
    if proj_out:
        per += _mm(L, clip["embed_dim"], proj_out)
    return n_images * per


def clip_text_flops(clip: dict, lengths: Sequence[int]) -> float:
    """The causal text tower over rows of ``lengths`` tokens (SOT to EOT)
    and the EOT row's projection."""
    w = clip["text_width"]
    return (_clip_layers(lengths, w, clip["text_layers"], causal=True)
            + len(lengths) * _mm(1, w, clip["embed_dim"]))


def l2_flops(queries: int, rows: int, dim: int) -> float:
    """The distance products of an L2 search."""
    return _mm(queries, dim, rows)


def t5_encoder_flops(t5: dict, lengths: Sequence[int]) -> float:
    """The encoder over rows of ``lengths`` unpadded tokens."""
    W = t5["num_heads"] * t5["d_kv"]
    total = 0.0
    for L in lengths:
        total += (4 * _mm(L, t5["d_model"], W)
                  + 2 * 2.0 * L * L * W + _ff(t5, L))
    return t5["num_layers"] * total


def t5_decode_flops(t5: dict, enc_lengths: Sequence[int],
                    steps: Sequence[int]) -> float:
    """Greedy decoding: per row the cross K/V of its ``enc_lengths``
    encoder states once, then ``steps`` steps; step t attends over t + 1
    decoded tokens and the row's encoder states; the tied head scores the
    whole vocabulary."""
    d, V = t5["d_model"], t5["vocab_size"]
    W = t5["num_heads"] * t5["d_kv"]
    n = t5["num_decoder_layers"]
    total = 0.0
    for L, S in zip(enc_lengths, steps):
        total += n * 2 * _mm(L, d, W)
        for t in range(S):
            total += n * (_mm(1, d, 3 * W) + 2 * 2.0 * (t + 1) * W
                          + _mm(1, W, d) + _mm(1, d, W) + 2 * 2.0 * L * W
                          + _mm(1, W, d) + _ff(t5, 1))
            total += _mm(1, d, V)
    return total


def decode_attention_work(heads: int, head_dim: int, keys: Sequence[int],
                          itemsize: int, bias_bytes: float = 0.0,
                          mask_bytes: float = 0.0) -> Tuple[float, float]:
    """(operations, bytes) of one decode-attention call: a query row a
    batch row, attending over ``keys[b]`` keys; q, the keys' K and V rows
    and the output are read or written once, with the bias and the mask
    it is given."""
    W = heads * head_dim
    n_keys = float(sum(keys))
    flops = 4.0 * heads * head_dim * n_keys
    nbytes = (2 * len(keys) * W + 2 * n_keys * W) * itemsize
    return flops, nbytes + bias_bytes + mask_bytes


def row_attention_work(heads: int, head_dim: int, lengths: Sequence[int],
                       itemsize: int, causal: bool, bias_bytes: float = 0.0,
                       mask_bytes: float = 0.0) -> Tuple[float, float]:
    """(operations, bytes) of one row-attention call over rows of
    ``lengths`` valid tokens: the two products over the key pairs each
    query may see; the rows' q, k, v and output once, the bias and the
    mask it is given."""
    W = heads * head_dim
    flops = 0.0
    rows = 0.0
    for L in lengths:
        pairs = L * (L + 1) / 2 if causal else L * L
        flops += 4.0 * pairs * W
        rows += L
    return flops, 4 * rows * W * itemsize + bias_bytes + mask_bytes
