"""MPR_Gen generative model: a visual-prefix T5 over CLIP image tokens.

Counterpart of the serving half of
``multimodalpromptretrieval_tpu/models/mprgen.py``: the config, the
compute-dtype cast, the ViT-token -> prefix tail and greedy prediction from
a precomputed prefix. The prefix is all CLIP tokens (B, 50, embed_dim)
prepended to the prompt's token embeddings; t5-large adds a trainable
512 -> 1024 projection (``needs_projection``; t5-small has none).

Not in this slice (ROADMAP A8-A10): training losses, the prediction-head /
BAN / ResNet / mapping variants.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.models.clip import CLIP, CLIPConfig
from multimodalpromptretrieval_tpu_torch.models.t5 import (
    T5,
    T5Config,
    t5_encode,
    t5_greedy_decode,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import dense, param


@dataclasses.dataclass(frozen=True)
class MPRGenConfig:
    t5: T5Config
    clip: CLIPConfig
    use_image_info: bool = True
    # variants this slice does not port: set, they are refused
    use_prediction_head: bool = False
    use_ban: bool = False
    use_mapping: bool = False
    max_source_length: int = 512
    compute_dtype: str = "float32"

    @property
    def needs_projection(self) -> bool:
        return self.t5.d_model != self.clip.embed_dim


def _check_supported(cfg: MPRGenConfig) -> None:
    unported = {"use_ban": cfg.use_ban,
                "use_prediction_head": cfg.use_prediction_head,
                "use_mapping": cfg.use_mapping}
    missing = [k for k, on in unported.items() if on]
    if missing:
        raise NotImplementedError(
            f"{missing}: only the generative ViT variant is ported "
            "(ROADMAP A9)")


class MPRGen(nn.Module):
    """The generative model's parameters: ``clip``, ``t5`` and, for
    t5-large, ``proj``. ``generator`` draws the seeded random init;
    ``None`` leaves the parameters to be loaded (``bridge.py``)."""

    def __init__(self, cfg: MPRGenConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        self.clip = CLIP(cfg.clip, generator)
        self.t5 = T5(cfg.t5, generator)
        if cfg.needs_projection:
            e, d = cfg.clip.embed_dim, cfg.t5.d_model
            self.proj = nn.Module()
            if generator is None:
                self.proj.weight = param((d, e), None)
            else:
                bound = e ** -0.5
                self.proj.weight = nn.Parameter(
                    (torch.rand((d, e), generator=generator) * 2 - 1)
                    * bound)
            self.proj.bias = param((d,), generator)


def init_mprgen(cfg: MPRGenConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> MPRGen:
    """Seeded random init on the host, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    model = MPRGen(cfg, gen)
    return model.to(device) if device is not None else model


def compute_dtype(cfg: MPRGenConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def cast_compute(params: MPRGen, cfg: MPRGenConfig) -> MPRGen:
    """fp32 master params -> a compute-dtype copy (the same object under
    float32). Serving makes the copy once, not per call."""
    if cfg.compute_dtype == "float32":
        return params
    return copy.deepcopy(params).to(compute_dtype(cfg))


def image_prefix_from_tokens(params: MPRGen, cfg: MPRGenConfig,
                             tokens: torch.Tensor) -> torch.Tensor:
    """ViT tokens (B, P, embed_dim) -> T5 prefix (B, P, d_model)."""
    if cfg.needs_projection:
        tokens = dense(tokens, params.proj.weight, params.proj.bias)
    return tokens


def generative_predict_from_prefix(params: MPRGen, cfg: MPRGenConfig,
                                   prefix: torch.Tensor,
                                   input_ids: torch.Tensor,
                                   text_mask: torch.Tensor,
                                   max_new_tokens: int = 20) -> torch.Tensor:
    """Greedy token ids from a precomputed visual prefix (B, P, d_model)
    and the prompt ids / mask (B, Lt)."""
    q_emb = params.t5.shared[input_ids.long()]
    B, P, _ = prefix.shape
    embeds = torch.cat([prefix.to(q_emb.dtype), q_emb], dim=1)
    mask = torch.cat([torch.ones((B, P), dtype=text_mask.dtype,
                                 device=text_mask.device), text_mask], dim=1)
    enc = t5_encode(params.t5, cfg.t5, embeds, mask)
    return t5_greedy_decode(params.t5, cfg.t5, enc, mask,
                            max_new_tokens=max_new_tokens)
