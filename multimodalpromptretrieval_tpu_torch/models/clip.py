"""CLIP ViT visual tower and text transformer (serving path).

Counterpart of ``multimodalpromptretrieval_tpu/models/clip.py``:

  * ``clip_image_tokens`` -- all (1 + grid^2) per-token image features in
    the shared space; row 0 is ``encode_image``'s pooled embedding, so one
    tower pass serves both the T5 prefix and the retrieval query;
  * ``clip_encode_text``  -- token + position embeddings, causal pre-LN
    transformer, ln_final, EOT pooling (argmax of the ids), projection.

``CLIPConfig.attention_impl`` (and ``text_attention_impl`` for the text
tower, when set) picks the path of both towers, as in the JAX package:

  * ``"row"``: (B*L, W) activations, the fused LayerNorm kernel (K2) around
    each block and the packed row-attention kernel (K1; scale
    1/sqrt(head_dim), causal for text). The text tower runs as (B, L, 3W)
    with ``causal=True``; the JAX package's grouped block-diagonal packing
    of short text sequences was a fix for TPU matrix-unit shapes and is
    mathematically the same computation, so it is not carried over;
  * ``"xla"``: the head-layout ``block`` of the JAX ``_transformer`` with the
    plain ``layer_norm`` and ``attention_xla``;
  * ``"pallas"``, ``"auto"``, ``"pallas_interpret"``: the same block with the
    flash kernel (K8). Another name raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.ops.attention import (
    multi_head_attention,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    LayerNorm,
    Linear,
    dense,
    layer_norm,
    param,
    quick_gelu,
)
from multimodalpromptretrieval_tpu_torch.ops.norm import fused_layer_norm
from multimodalpromptretrieval_tpu_torch.ops.row_attention import (
    row_attention_packed,
)
from multimodalpromptretrieval_tpu_torch.train import profiling


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    patch_size: int = 32
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    vision_heads_override: int = 0
    text_heads_override: int = 0
    attention_impl: str = "xla"
    text_attention_impl: str = ""

    @property
    def vision_heads(self) -> int:
        return self.vision_heads_override or max(1, self.vision_width // 64)

    @property
    def text_heads(self) -> int:
        return self.text_heads_override or max(1, self.text_width // 64)

    @property
    def grid(self) -> int:
        return self.image_resolution // self.patch_size

    @property
    def num_image_tokens(self) -> int:
        return self.grid * self.grid + 1

    @staticmethod
    def vit_b32() -> "CLIPConfig":
        return CLIPConfig()


# CLIP's torchvision preprocess normalization constants (clip/clip.py)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, generator: Optional[torch.Generator]):
        super().__init__()
        s = width ** -0.5
        self.qkv = Linear(width, 3 * width, bias=True, std=s,
                          generator=generator)
        self.out = Linear(width, width, bias=True, std=s,
                          generator=generator)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, generator: Optional[torch.Generator]):
        super().__init__()
        s = width ** -0.5
        self.fc = Linear(width, 4 * width, bias=True, std=s,
                         generator=generator)
        self.proj = Linear(4 * width, width, bias=True, std=s,
                           generator=generator)


class CLIPBlock(nn.Module):
    def __init__(self, width: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.ln_1 = LayerNorm(width, generator)
        self.attn = CLIPAttention(width, generator)
        self.ln_2 = LayerNorm(width, generator)
        self.mlp = CLIPMLP(width, generator)


class CLIPVisual(nn.Module):
    def __init__(self, cfg: CLIPConfig, generator: Optional[torch.Generator]):
        super().__init__()
        vw = cfg.vision_width
        s = vw ** -0.5
        self.conv1 = Linear(3 * cfg.patch_size ** 2, vw, bias=False, std=s,
                            generator=generator)
        self.class_embedding = param((vw,), generator, std=s)
        self.pos_embedding = param((cfg.num_image_tokens, vw), generator,
                                   std=s)
        self.ln_pre = LayerNorm(vw, generator)
        self.blocks = nn.ModuleList(CLIPBlock(vw, generator)
                                    for _ in range(cfg.vision_layers))
        self.ln_post = LayerNorm(vw, generator)
        self.proj = Linear(vw, cfg.embed_dim, bias=False, std=s,
                           generator=generator)


class CLIPText(nn.Module):
    def __init__(self, cfg: CLIPConfig, generator: Optional[torch.Generator]):
        super().__init__()
        tw = cfg.text_width
        self.token_embedding = param((cfg.vocab_size, tw), generator,
                                     std=0.02)
        self.pos_embedding = param((cfg.context_length, tw), generator,
                                   std=0.01)
        self.blocks = nn.ModuleList(CLIPBlock(tw, generator)
                                    for _ in range(cfg.text_layers))
        self.ln_final = LayerNorm(tw, generator)
        self.text_projection = Linear(tw, cfg.embed_dim, bias=False,
                                      std=tw ** -0.5, generator=generator)


class CLIP(nn.Module):
    """Parameters of both towers. ``generator`` draws the seeded random
    init (CLIP's scheme); ``None`` leaves them to be loaded."""

    def __init__(self, cfg: CLIPConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.visual = CLIPVisual(cfg, generator)
        self.text = CLIPText(cfg, generator)
        self.logit_scale = param((), generator, fill=2.6592)


def _transformer(blocks: nn.ModuleList, x: torch.Tensor, heads: int, *,
                 causal: bool, attention_impl: str) -> torch.Tensor:
    """Pre-LN blocks over (B, L, W). ``"row"``: (B*L, W) rows, one GEMM per
    dense, the fused LayerNorm kernel and the packed row-attention kernel;
    otherwise the head-layout block with ``multi_head_attention`` under
    ``attention_impl`` over (B, H, L, Dh) views of the fused QKV output."""
    B, L, W = x.shape
    Dh = W // heads
    if attention_impl != "row":
        for p in blocks:
            h = layer_norm(x, p.ln_1.weight, p.ln_1.bias)
            qkv = p.attn.qkv(h).view(B, L, 3, heads, Dh)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            o = multi_head_attention(q, k, v, causal=causal,
                                     scale=Dh ** -0.5, impl=attention_impl)
            x = x + p.attn.out(o.transpose(1, 2).reshape(B, L, W))
            h = layer_norm(x, p.ln_2.weight, p.ln_2.bias)
            x = x + p.mlp.proj(quick_gelu(p.mlp.fc(h)))
        return x
    x = x.reshape(B * L, W)
    for p in blocks:
        h = fused_layer_norm(x, p.ln_1.weight, p.ln_1.bias)
        qkv = p.attn.qkv(h)
        o = row_attention_packed(qkv.reshape(B, L, 3 * W), heads=heads,
                                 scale=Dh ** -0.5, causal=causal)
        x = x + p.attn.out(o.reshape(B * L, W))
        h = fused_layer_norm(x, p.ln_2.weight, p.ln_2.bias)
        x = x + p.mlp.proj(quick_gelu(p.mlp.fc(h)))
    return x.reshape(B, L, W)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, grid^2, 3 * p^2), channel-major within a patch
    (the flattened conv kernel's order)."""
    B, C, H, W = images.shape
    g = H // patch
    x = images.reshape(B, C, g, patch, g, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # B, gy, gx, C, py, px
    return x.reshape(B, g * g, C * patch * patch)


def clip_image_tokens(params: CLIP, cfg: CLIPConfig,
                      images: torch.Tensor) -> torch.Tensor:
    """(B, 3, R, R) preprocessed images -> (B, 1 + grid^2, embed_dim)."""
    v = params.visual
    x = dense(patchify(images, cfg.patch_size), v.conv1.weight)
    cls = v.class_embedding.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + v.pos_embedding.to(x.dtype)
    x = layer_norm(x, v.ln_pre.weight, v.ln_pre.bias)
    x = _transformer(v.blocks, x, cfg.vision_heads, causal=False,
                     attention_impl=cfg.attention_impl)
    x = layer_norm(x, v.ln_post.weight, v.ln_post.bias)
    return dense(x, v.proj.weight.to(x.dtype))


def clip_encode_image(params: CLIP, cfg: CLIPConfig,
                      images: torch.Tensor) -> torch.Tensor:
    """Pooled image embedding (B, embed_dim), OpenAI ``encode_image``."""
    return clip_image_tokens(params, cfg, images)[:, 0]


def truncate_text_ids(ids, multiple: int = 8):
    """Drop all-padding tail columns (bucketed to ``multiple``); the text
    embedding is identical on the shortened batch (causal attention + EOT
    pooling). Row length is the LAST nonzero position + 1: BPE id 0 is the
    real token '!', so a nonzero count could cut the EOT column."""
    ids = np.asarray(ids)
    nz = ids != 0
    lengths = np.where(nz.any(axis=1),
                       ids.shape[1] - nz[:, ::-1].argmax(axis=1),
                       ids.shape[1])
    width = int(max(1, lengths.max()))
    width = min(ids.shape[1], -(-width // multiple) * multiple)
    return ids[:, :width]


def clip_encode_text(params: CLIP, cfg: CLIPConfig,
                     token_ids: torch.Tensor) -> torch.Tensor:
    """Pooled text embedding (B, embed_dim), OpenAI ``encode_text``.
    Pooling takes the EOT position = argmax of the ids (EOT has the
    highest id). Under ``train/profiling`` the span ``mpr.clip.text``."""
    with profiling.span("mpr.clip.text"):
        t = params.text
        token_ids = token_ids.long()
        L = token_ids.shape[1]
        x = t.token_embedding[token_ids]
        x = x + t.pos_embedding[:L].to(x.dtype)
        x = _transformer(t.blocks, x, cfg.text_heads, causal=True,
                         attention_impl=(cfg.text_attention_impl
                                         or cfg.attention_impl))
        x = layer_norm(x, t.ln_final.weight, t.ln_final.bias)
        eot = torch.argmax(token_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return dense(pooled, t.text_projection.weight.to(x.dtype))
