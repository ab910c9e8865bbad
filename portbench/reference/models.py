"""The plain reference: T5, the CLIP towers, L2 distances, the vote and
splice.

Plain PyTorch, written from the published descriptions (T5: Raffel et al.
2020 with HF's ``T5Model`` numerics; CLIP: Radford et al. 2021, OpenAI's
``model.py``; MPR_Gen's retrieval hint: the reference repository's
``VQAFeatureDataset.retrieve_closest_qa_pairs``), with no kernel, cache or
batching of the program. It imports nothing of the program: weights come
in as a dict of tensors by name, in the layout the benchmark makes them
(``portbench/weights.py``): every dense weight (out, in), T5's q, k and v
stacked in one ``qkv`` weight.

Call it under :func:`exact_fp32`: float32, TF32 off. Under
:func:`products_through` every product's operands are rounded first (the
check's control: :func:`fp8`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]

QUANTIFIER_BUCKETS = ["very unlikely", "unlikely", "maybe", "likely",
                      "very likely", "certainly"]


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 (a float32 GEMM may otherwise run in
    TF32 on the card), without autograd."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


_round = None  # the rounding of every product's operands, or None


@contextlib.contextmanager
def products_through(fn):
    """Round both operands of every product through ``fn`` inside."""
    global _round
    saved, _round = _round, fn
    try:
        yield
    finally:
        _round = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one per-tensor scale (the largest
    magnitude to 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, its operands rounded first under :func:`products_through`."""
    if _round is not None:
        a, b = _round(a), _round(b)
    return a @ b


def _lin(x, p: Params, name: str, bias: bool = False):
    y = mm(x, p[name + ".weight"].float().t())
    if bias:
        y = y + p[name + ".bias"].float()
    return y


# ---------------------------------------------------------------------------
# CLIP (OpenAI model.py: pre-LN residual attention blocks, QuickGELU)
# ---------------------------------------------------------------------------


def _layer_norm(x, p: Params, name: str, eps: float = 1e-5):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], p[name + ".weight"].float(), p[name + ".bias"].float(),
        eps)


def _clip_block(x, p: Params, pre: str, heads: int, causal: bool):
    B, L, W = x.shape
    Dh = W // heads
    h = _layer_norm(x, p, pre + ".ln_1")
    qkv = _lin(h, p, pre + ".attn.qkv", bias=True).view(B, L, 3, heads, Dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    s = mm(q, k.transpose(-1, -2)) * Dh ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool,
                                     device=x.device).triu(1), float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, L, W)
    x = x + _lin(o, p, pre + ".attn.out", bias=True)
    h = _layer_norm(x, p, pre + ".ln_2")
    h = _lin(h, p, pre + ".mlp.fc", bias=True)
    h = h * torch.sigmoid(1.702 * h)
    return x + _lin(h, p, pre + ".mlp.proj", bias=True)


def vit_tokens(p: Params, cfg: dict, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, R, R) normalized images -> (B, 1 + grid^2, embed_dim): every
    token through ``ln_post`` and ``proj`` (token 0 is the pooled image
    embedding, all of them MPR_Gen's prefix)."""
    patch, W = cfg["patch_size"], cfg["vision_width"]
    B, C, R, _ = images.shape
    g = R // patch
    x = images.float().reshape(B, C, g, patch, g, patch)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, C * patch * patch)
    x = _lin(x, p, "clip.visual.conv1")
    cls = p["clip.visual.class_embedding"].float().expand(B, 1, W)
    x = torch.cat([cls, x], dim=1) + p["clip.visual.pos_embedding"].float()
    x = _layer_norm(x, p, "clip.visual.ln_pre")
    heads = cfg.get("vision_heads_override") or max(1, W // 64)
    for i in range(cfg["vision_layers"]):
        x = _clip_block(x, p, f"clip.visual.blocks.{i}", heads, False)
    x = _layer_norm(x, p, "clip.visual.ln_post")
    return _lin(x, p, "clip.visual.proj")


def clip_text(p: Params, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """(B, L) CLIP token ids (SOT ... EOT 0 ...) -> (B, embed_dim), pooled
    at the EOT token (the largest id)."""
    ids = ids.long()
    B, L = ids.shape
    W = cfg["text_width"]
    x = (p["clip.text.token_embedding"].float()[ids]
         + p["clip.text.pos_embedding"].float()[:L])
    heads = cfg.get("text_heads_override") or max(1, W // 64)
    for i in range(cfg["text_layers"]):
        x = _clip_block(x, p, f"clip.text.blocks.{i}", heads, True)
    x = _layer_norm(x, p, "clip.text.ln_final")
    pooled = x[torch.arange(B, device=x.device), ids.argmax(dim=-1)]
    return _lin(pooled, p, "clip.text.text_projection")


def prefix_from_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """ViT tokens -> the T5 prefix: through the 512 -> d_model projection
    where the model has one (t5-large), else unchanged."""
    if "proj.weight" in p:
        return _lin(tokens, p, "proj", bias=True)
    return tokens


# ---------------------------------------------------------------------------
# Retrieval: L2 distances, majority vote with the quantifier, the hint string
# ---------------------------------------------------------------------------


def l2_distances(query: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, N) Euclidean distances over the raw embeddings."""
    return torch.cdist(query.double(), index.double()).float()


def hint(answers: Sequence[str], use_quantifier: bool = True) -> str:
    """The hint of the top-k answers in retrieval order: the first answer
    with the largest count wins; certainty = count / k picks the bucket."""
    counts: Dict[str, int] = {}
    for a in answers:
        counts[a] = counts.get(a, 0) + 1
    best = max(counts.values())
    winner = next(a for a in answers if counts[a] == best)
    if not use_quantifier:
        return f"The most frequent answer is {winner}"
    bucket = QUANTIFIER_BUCKETS[int(best / len(answers) * 5)]
    return f"I believe the answer is {bucket} {winner}"


# ---------------------------------------------------------------------------
# T5 (HF numerics: RMS norm, unscaled scores, relative position buckets,
# tied head scaled by d_model^-0.5, ReLU feed-forward)
# ---------------------------------------------------------------------------


def _bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
            max_distance: int) -> torch.Tensor:
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out = out + (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(rel.float().clamp(min=1.0) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return out + torch.where(rel < max_exact, rel, large)


def _position_bias(p: Params, stack: str, cfg: dict, q_len: int, k_len: int,
                   bidirectional: bool, device) -> torch.Tensor:
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    b = _bucket(mem - ctx, bidirectional,
                cfg["relative_attention_num_buckets"],
                cfg["relative_attention_max_distance"])
    return p[f"t5.{stack}.rel_bias"].float()[b].permute(2, 0, 1)  # (H, q, k)


def _rms(x, w, eps):
    return w.float() * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                        + eps))


def _t5_attention(p: Params, name: str, cfg: dict, xq, xkv, bias,
                  key_mask: Optional[torch.Tensor], causal: bool):
    B, Lq, _ = xq.shape
    Lk = xkv.shape[1]
    H, Dh = cfg["num_heads"], cfg["d_kv"]
    W = H * Dh
    w = p[name + ".qkv"].float()
    q = mm(xq, w[:W].t()).view(B, Lq, H, Dh).transpose(1, 2)
    k = mm(xkv, w[W:2 * W].t()).view(B, Lk, H, Dh).transpose(1, 2)
    v = mm(xkv, w[2 * W:].t()).view(B, Lk, H, Dh).transpose(1, 2)
    s = mm(q, k.transpose(-1, -2))
    if bias is not None:
        s = s + bias[None]
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :].bool(), float("-inf"))
    if causal:
        s = s.masked_fill(torch.ones(Lq, Lk, dtype=torch.bool,
                                     device=xq.device).triu(1), float("-inf"))
    o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, Lq, W)
    return mm(o, p[name + ".o.weight"].float().t())


def _ff(p: Params, name: str, x):
    h = torch.relu(mm(x, p[name + ".wi.weight"].float().t()))
    return mm(h, p[name + ".wo.weight"].float().t())


def t5_encode(p: Params, cfg: dict, embeds: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """(B, L, d) input embeddings, (B, L) {0, 1} mask -> encoder states."""
    eps = cfg["layer_norm_epsilon"]
    L = embeds.shape[1]
    bias = _position_bias(p, "encoder", cfg, L, L, True, embeds.device)
    x = embeds.float()
    for i in range(cfg["num_layers"]):
        pre = f"t5.encoder.block.{i}"
        h = _rms(x, p[pre + ".attn_ln"], eps)
        x = x + _t5_attention(p, pre + ".attn", cfg, h, h, bias, mask, False)
        h = _rms(x, p[pre + ".ff_ln"], eps)
        x = x + _ff(p, pre + ".ff", h)
    return _rms(x, p["t5.encoder.final_ln"], eps)


def t5_decoder_logits(p: Params, cfg: dict, enc: torch.Tensor,
                      enc_mask: torch.Tensor,
                      dec_ids: torch.Tensor) -> torch.Tensor:
    """Teacher forcing: (B, T) decoder inputs (start token first) ->
    (B, T, vocab) logits of the next token at each position."""
    eps = cfg["layer_norm_epsilon"]
    T = dec_ids.shape[1]
    shared = p["t5.shared"].float()
    bias = _position_bias(p, "decoder", cfg, T, T, False, enc.device)
    x = shared[dec_ids.long()]
    for i in range(cfg["num_decoder_layers"]):
        pre = f"t5.decoder.block.{i}"
        h = _rms(x, p[pre + ".self_ln"], eps)
        x = x + _t5_attention(p, pre + ".self_attn", cfg, h, h, bias, None,
                              True)
        h = _rms(x, p[pre + ".cross_ln"], eps)
        x = x + _t5_attention(p, pre + ".cross_attn", cfg, h, enc, None,
                              enc_mask, False)
        h = _rms(x, p[pre + ".ff_ln"], eps)
        x = x + _ff(p, pre + ".ff", h)
    x = _rms(x, p["t5.decoder.final_ln"], eps) * cfg["d_model"] ** -0.5
    return mm(x, shared.t())


def prompt_ids(tokenizer, question: str, task: str, hint_text: str,
               max_length: int) -> List[int]:
    """The T5 prompt ``"Answer the {task} question: " + question + hint``
    with EOS, truncated as T5's tokenizer truncates (content dropped, EOS
    kept)."""
    return tokenizer.encode(f"Answer the {task} question: " + question
                            + hint_text, max_length=max_length)


def pad_rows(rows: Sequence[Sequence[int]]) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(ids, mask) of token rows padded with 0 to the longest."""
    L = max(len(r) for r in rows)
    ids = torch.zeros((len(rows), L), dtype=torch.long)
    mask = torch.zeros((len(rows), L), dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.as_tensor(list(r))
        mask[i, :len(r)] = 1
    return ids, mask
