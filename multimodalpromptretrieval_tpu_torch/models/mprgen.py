"""MPR_Gen: a visual-prefix T5 over CLIP image features, and its variants.

Counterpart of ``multimodalpromptretrieval_tpu/models/mprgen.py``: the
config, the trainable mask, the compute-dtype cast, the frozen vision trunk
and its trainable tail, and the loss and prediction of each variant, from
images or cached vision tokens:

  * generative (the default): the prefix is all CLIP tokens (B, 50,
    embed_dim) prepended to the prompt's token embeddings (t5-large adds a
    trainable 512 -> 1024 projection, ``needs_projection``); greedy token
    ids, also from a precomputed prefix (the server's staged tables);
  * the ResNet tower (``resnet``, the reference's "Use RNx4" branch): the
    prefix is the frozen ModifiedResNet's layer4 grid (B, grid^2, C), no CLS
    token, through a trainable ``rn_proj`` (C -> d_model); the ViT stays for
    the retrieval queries (quirk #2);
  * the mapping MLP (``use_mapping``): Linear -> ReLU -> Linear (plus a
    learned ``logit_scale``, trained by ``train/mapping.py``) on the ViT
    tokens in CLIP's space, before the t5-large projection;
  * text-only (``use_image_info=False``): the prompt alone, no prefix;
  * prediction head (``use_prediction_head``): a linear head over the
    encoder state at ``prefix + longest prompt in the batch - 1``, the last
    position under the reference's longest-row padding (quirk #10), so a
    row's answer depends on the rows that share its batch; class ids;
  * BAN (``use_prediction_head`` and ``use_ban``): L2-normalised prompt
    embeddings through the encoder and L2-normalised image tokens, fused
    by ``models/ban.py`` with ``glimpse`` = 10 glimpses, then the head.

The losses and predictions take ``tp``, the "model" axis of a
tensor-parallel mesh, down to T5 (``models/t5.py``); the rest of the model
is replicated and runs whole on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.models import ban as ban_ops
from multimodalpromptretrieval_tpu_torch.models import moe_lm
from multimodalpromptretrieval_tpu_torch.models.clip import (
    CLIP,
    CLIPConfig,
    clip_image_tokens,
)
from multimodalpromptretrieval_tpu_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    resnet_grid_features,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import (
    T5,
    T5Config,
    t5_encode,
    t5_greedy_decode,
    t5_loss,
    t5_spec_greedy_decode,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    dense,
    dropout,
    param,
    uniform_param,
)


@dataclasses.dataclass(frozen=True)
class MPRGenConfig:
    t5: T5Config
    clip: CLIPConfig
    # the ResNet tower: when set, the prefix is its grid through rn_proj
    resnet: Optional[ResNetConfig] = None
    use_image_info: bool = True
    use_prediction_head: bool = False
    use_ban: bool = False
    use_mapping: bool = False
    # the head's classes (prediction-head and BAN variants)
    num_classes: int = 0
    # the reference's BAN modules hardcode 10 glimpses whatever the config
    # says (quirk #9); the experiments never read a config key for it
    glimpse: int = 10
    # train only the shared embedding matrix (trainable_mask)
    freeze: bool = False
    max_source_length: int = 512
    max_target_length: int = 128
    # master params stay fp32 (AdamW moments too); forward and backward run
    # in this dtype
    compute_dtype: str = "float32"
    # the answer generator: T5 (None) or the decoder-only MoE LM
    # (models/moe_lm.py), served only, its weights held in compute_dtype
    lm: Optional[moe_lm.LMConfig] = None

    @property
    def d_model(self) -> int:
        """The generator's width (the prefix's)."""
        return self.lm.hidden_size if self.lm is not None else self.t5.d_model

    @property
    def eos_token_id(self) -> int:
        return (self.lm.eos_token_id if self.lm is not None
                else self.t5.eos_token_id)

    @property
    def needs_projection(self) -> bool:
        return self.d_model != self.clip.embed_dim

    @property
    def num_image_tokens(self) -> int:
        if self.resnet is not None:
            return self.resnet.grid ** 2  # no CLS token on the RN path
        return self.clip.num_image_tokens


class Mapping(nn.Module):
    """The cross-modal mapping: ``fc1``, ``fc2`` (dim -> dim, torch's
    Linear init) and the CLIP-style learned temperature ``logit_scale``."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("fc1", "fc2"):
            fc = nn.Module()
            fc.weight = uniform_param((dim, dim), dim ** -0.5, generator)
            fc.bias = uniform_param((dim,), dim ** -0.5, generator)
            setattr(self, name, fc)
        self.logit_scale = param((), generator, fill=2.6592)


def mapping_apply(p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear."""
    h = torch.relu(dense(x, p.fc1.weight, p.fc1.bias))
    return dense(h, p.fc2.weight, p.fc2.bias)


class MPRGen(nn.Module):
    """The model's parameters: ``clip``, ``t5`` (``lm`` in its place for
    the LM generator), for t5-large and the LM ``proj``, for
    the head variants ``head`` (d_model -> num_classes), for BAN ``ban``
    (``att``, a BiAttention, and ``res``, a BiResNet, both at d_model), for
    the RN path ``clip_rn`` (the ResNet) and ``rn_proj`` (C -> d_model), and
    ``mapping`` under ``use_mapping``. ``generator`` draws the seeded random
    init; ``None`` leaves the parameters to be loaded (``bridge.py``)."""

    def __init__(self, cfg: MPRGenConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.clip = CLIP(cfg.clip, generator)
        if cfg.lm is not None:
            self.lm = moe_lm.MoELM(cfg.lm, generator)
        else:
            self.t5 = T5(cfg.t5, generator)
        if cfg.needs_projection:
            e, d = cfg.clip.embed_dim, cfg.d_model
            self.proj = nn.Module()
            self.proj.weight = uniform_param((d, e), e ** -0.5, generator)
            self.proj.bias = param((d,), generator)
        d = cfg.t5.d_model
        if cfg.use_prediction_head:
            self.head = nn.Module()
            self.head.weight = uniform_param((cfg.num_classes, d), d ** -0.5,
                                             generator)
            self.head.bias = uniform_param((cfg.num_classes,), d ** -0.5,
                                           generator)
        if cfg.use_ban:
            self.ban = nn.Module()
            self.ban.att = ban_ops.BiAttention(d, d, d, cfg.glimpse,
                                               generator)
            self.ban.res = ban_ops.BiResNet(d, d, cfg.glimpse, generator)
        # drawn after the other parts, so that a variant without them draws
        # the same CLIP, T5 and heads from a seed
        if cfg.resnet is not None:
            self.clip_rn = ResNet(cfg.resnet, generator)
            c = cfg.resnet.final_channels
            self.rn_proj = nn.Module()
            self.rn_proj.weight = uniform_param((d, c), c ** -0.5, generator)
            self.rn_proj.bias = param((d,), generator)
        if cfg.use_mapping:
            self.mapping = Mapping(cfg.clip.embed_dim, generator)


def init_mprgen(cfg: MPRGenConfig, seed: int = 0,
                device: Optional[torch.device] = None) -> MPRGen:
    """Seeded random init on the host, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    model = MPRGen(cfg, gen)
    return model.to(device) if device is not None else model


def trainable_mask(params: MPRGen, cfg: MPRGenConfig) -> Dict[str, bool]:
    """Parameter name -> whether the optimizer may update it. The CLIP
    towers and the ResNet are always frozen; ``cfg.freeze`` also freezes all of T5 except
    the shared embedding matrix. The mask belongs to the optimizer
    (``adamw_update(trainable=)``); :func:`set_trainable` also tells autograd
    not to compute what it would discard."""
    mask = {}
    for name, _ in params.named_parameters():
        if name.startswith(("clip.", "clip_rn.")):
            mask[name] = False
        elif cfg.freeze and name.startswith("t5."):
            mask[name] = name == "t5.shared"
        else:
            mask[name] = True
    return mask


def set_trainable(params: MPRGen, mask: Dict[str, bool]) -> None:
    for name, p in params.named_parameters():
        p.requires_grad_(mask[name])


def compute_dtype(cfg: MPRGenConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def cast_compute(params: MPRGen, cfg: MPRGenConfig,
                 out: Optional[MPRGen] = None) -> MPRGen:
    """fp32 master params -> a compute-dtype copy (the same object under
    float32). ``out``, a copy made by an earlier call, is refreshed in place
    instead (serving makes the copy once; the train step refreshes it after
    every update).

    The copy's parameters are autograd leaves. The cotangent of a cast is
    the cast back, so the gradient of a loss with respect to a master is
    the gradient with respect to its copy, upcast: the optimizer sees fp32
    gradients on fp32 masters, and a parameter used several times
    (``t5.shared``) accumulates its gradient in the compute dtype, as in the
    JAX package. int8 serving weights (``ops/quant.QWeight``, module
    attributes, not parameters) keep their int8 payload and fp32 scale.
    The LM generator is held in the compute dtype already: the copy shares
    it (``moe_lm.hold_in``), and casts the rest."""
    if cfg.compute_dtype == "float32":
        return params
    if out is None and cfg.lm is not None:
        copied = copy.deepcopy(params, {id(params.lm): params.lm})
        for name, child in copied.named_children():
            if name != "lm":
                child.to(compute_dtype(cfg))
        return copied
    if out is None:
        return copy.deepcopy(params).to(compute_dtype(cfg))
    with torch.no_grad():
        torch._foreach_copy_(list(out.parameters()),
                             list(params.parameters()))
    return out


def vision_trunk(params: MPRGen, cfg: MPRGenConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """The FROZEN part of the visual path: (B, 3, R, R) images -> all CLIP
    ViT tokens (B, 50, embed_dim), or the ResNet's layer4 grid (B, grid^2,
    C) on the RN path, outside the autograd graph. Its output does not
    change during training, so it is computed once per unique image and
    cached (``TrainingExperiment.build_vision_token_cache``)."""
    with torch.no_grad():
        if cfg.resnet is not None:
            return resnet_grid_features(params.clip_rn, cfg.resnet, images)
        return clip_image_tokens(params.clip, cfg.clip, images)


def image_prefix_from_tokens(params: MPRGen, cfg: MPRGenConfig,
                             tokens: torch.Tensor) -> torch.Tensor:
    """The ViT path's trainable tail: tokens (B, P, embed_dim) -> T5 prefix
    (B, P, d_model). No gradient flows back into the tokens. The mapping
    runs in CLIP's space, then the t5-large projection: the reference
    projects first and then maps, which cannot run when both are on (the
    mapping takes 512-d features); with one of them on, the orders agree."""
    tokens = tokens.detach()
    if cfg.use_mapping:
        tokens = mapping_apply(params.mapping, tokens)
    if cfg.needs_projection:
        tokens = dense(tokens, params.proj.weight, params.proj.bias)
    return tokens


def prefix_from_vision_tokens(params: MPRGen, cfg: MPRGenConfig,
                              tokens: torch.Tensor) -> torch.Tensor:
    """The trainable tail of either trunk: the RN grid through ``rn_proj``,
    ViT tokens through :func:`image_prefix_from_tokens`."""
    if cfg.resnet is not None:
        return dense(tokens.detach(), params.rn_proj.weight,
                     params.rn_proj.bias)
    return image_prefix_from_tokens(params, cfg, tokens)


def image_prefix(params: MPRGen, cfg: MPRGenConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """(B, 3, R, R) preprocessed images -> (B, P, d_model) prefix."""
    return prefix_from_vision_tokens(params, cfg,
                                     vision_trunk(params, cfg, images))


def combine_inputs(params: MPRGen, cfg: MPRGenConfig,
                   images: Optional[torch.Tensor], input_ids: torch.Tensor,
                   text_mask: torch.Tensor,
                   tokens: Optional[torch.Tensor] = None):
    """(inputs_embeds, attention_mask) with the image prefix prepended iff
    ``use_image_info``. ``tokens``, a precomputed :func:`vision_trunk`
    output, is used in place of ``images`` when given."""
    q_emb = params.t5.shared[input_ids.long()]
    if not cfg.use_image_info:
        return q_emb, text_mask
    prefix = (prefix_from_vision_tokens(params, cfg, tokens)
              if tokens is not None else image_prefix(params, cfg, images))
    return _prepend(prefix, q_emb, text_mask)


def _prepend(prefix, q_emb, text_mask):
    B, P, _ = prefix.shape
    embeds = torch.cat([prefix.to(q_emb.dtype), q_emb], dim=1)
    mask = torch.cat([torch.ones((B, P), dtype=text_mask.dtype,
                                 device=text_mask.device), text_mask], dim=1)
    return embeds, mask


def generative_loss(params: MPRGen, cfg: MPRGenConfig, images, input_ids,
                    text_mask, labels, gen=None, tokens=None,
                    tp=None) -> torch.Tensor:
    """Cross-entropy of the answer tokens. ``gen`` (a ``torch.Generator``
    on the device) enables T5's training dropout."""
    if cfg.lm is not None:
        raise ValueError("the LM generator is served only: it has no "
                         "training loss")
    embeds, mask = combine_inputs(params, cfg, images, input_ids, text_mask,
                                  tokens)
    return t5_loss(params.t5, cfg.t5, embeds, mask, labels, gen, tp)


@torch.no_grad()
def generative_predict(params: MPRGen, cfg: MPRGenConfig, images, input_ids,
                       text_mask, max_new_tokens: int = 20,
                       tokens=None, tp=None) -> torch.Tensor:
    """Greedy token ids from images (or cached vision tokens)."""
    if cfg.lm is not None:
        prefix = None
        if cfg.use_image_info:
            prefix = (prefix_from_vision_tokens(params, cfg, tokens)
                      if tokens is not None
                      else image_prefix(params, cfg, images))
        return generative_predict_from_prefix(params, cfg, prefix, input_ids,
                                              text_mask, max_new_tokens,
                                              tp=tp)
    embeds, mask = combine_inputs(params, cfg, images, input_ids, text_mask,
                                  tokens)
    enc = t5_encode(params.t5, cfg.t5, embeds, mask, tp=tp)
    return t5_greedy_decode(params.t5, cfg.t5, enc, mask,
                            max_new_tokens=max_new_tokens, tp=tp)


def generative_predict_from_prefix(params: MPRGen, cfg: MPRGenConfig,
                                   prefix: torch.Tensor,
                                   input_ids: torch.Tensor,
                                   text_mask: torch.Tensor,
                                   max_new_tokens: int = 20,
                                   draft_ids: Optional[torch.Tensor] = None,
                                   spec_block: int = 0,
                                   tp=None) -> torch.Tensor:
    """Greedy token ids from a precomputed visual prefix (B, P, d_model)
    and the prompt ids / mask (B, Lt). With ``draft_ids`` (B, Dw) and
    ``spec_block`` > 0 the decode verifies the drafts
    (``t5_spec_greedy_decode``): the same ids in fewer passes. ``tp``: the
    tensor-parallel greedy decode (no drafts). With the LM generator
    (``cfg.lm``) the LM prefills [prefix || prompt] and decodes greedily
    (``moe_lm.lm_generate``); ``prefix`` may be None (no image); it takes
    neither drafts nor ``tp`` (the experiment and the server refuse
    them)."""
    if cfg.lm is not None:
        return moe_lm.lm_generate(params.lm, cfg.lm, prefix, input_ids,
                                  text_mask, max_new_tokens)
    embeds, mask = _prepend(prefix, params.t5.shared[input_ids.long()],
                            text_mask)
    enc = t5_encode(params.t5, cfg.t5, embeds, mask, tp=tp)
    if draft_ids is not None and spec_block > 0:
        return t5_spec_greedy_decode(params.t5, cfg.t5, enc, mask, draft_ids,
                                     max_new_tokens=max_new_tokens,
                                     block=spec_block)
    return t5_greedy_decode(params.t5, cfg.t5, enc, mask,
                            max_new_tokens=max_new_tokens, tp=tp)


# ---------------------------------------------------------------------------
# Prediction-head variant
# ---------------------------------------------------------------------------


def head_logits(params: MPRGen, cfg: MPRGenConfig, images, input_ids,
                text_mask, gen=None, tokens=None, *,
                longest=None, tp=None) -> torch.Tensor:
    """The head over the encoder state at ``prefix + longest prompt - 1``:
    the last position of the reference's longest-row padding (quirk #10),
    found without a host sync. ``longest`` (a 0-d tensor), when given, is
    that length over a batch of which these rows are a part (a
    data-parallel rank's). The encoder runs without dropout, as in the
    JAX package; ``gen`` drops the pooled vector at 0.1."""
    embeds, mask = combine_inputs(params, cfg, images, input_ids, text_mask,
                                  tokens)
    enc = t5_encode(params.t5, cfg.t5, embeds, mask, tp=tp)
    prefix = cfg.num_image_tokens if cfg.use_image_info else 0
    if longest is None:
        longest = torch.amax(torch.sum(text_mask, dim=1))
    last = prefix + longest - 1
    pooled = enc.index_select(1, last.reshape(1).long())[:, 0]
    pooled = dropout(pooled, 0.1, gen)
    return dense(pooled, params.head.weight, params.head.bias)


def _class_ce(logits: torch.Tensor,
              class_labels: torch.Tensor) -> torch.Tensor:
    """Row-mean cross-entropy; rows labelled -100 (a batch's fill rows)
    leave both the sum and the divisor."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = class_labels >= 0
    safe = torch.where(valid, class_labels, 0).long()
    ll = torch.gather(logp, 1, safe[:, None])[:, 0]
    return (-torch.sum(ll * valid)
            / torch.clamp(torch.sum(valid), min=1))


def head_loss(params, cfg, images, input_ids, text_mask, class_labels,
              gen=None, tokens=None, *, longest=None,
              tp=None) -> torch.Tensor:
    return _class_ce(head_logits(params, cfg, images, input_ids, text_mask,
                                 gen, tokens, longest=longest, tp=tp),
                     class_labels)


def head_predict(params, cfg, images, input_ids, text_mask,
                 tokens=None, *, longest=None, tp=None) -> torch.Tensor:
    """int32 class ids (argmax: the first index on ties)."""
    logits = head_logits(params, cfg, images, input_ids, text_mask,
                         tokens=tokens, longest=longest, tp=tp)
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# BAN variant
# ---------------------------------------------------------------------------


def _l2_rows(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the last axis, in x's dtype and with no epsilon: a
    zero row gives NaN, as in the JAX package."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=2, keepdim=True))


def _ban_features(params: MPRGen, cfg: MPRGenConfig, images, input_ids,
                  tokens=None):
    """L2-normalised prompt token embeddings (the encoder's input) and
    L2-normalised image tokens; the prompt carries no image prefix."""
    q = _l2_rows(params.t5.shared[input_ids.long()])
    img = (prefix_from_vision_tokens(params, cfg, tokens)
           if tokens is not None else image_prefix(params, cfg, images))
    return q, _l2_rows(img)


def ban_logits(params: MPRGen, cfg: MPRGenConfig, images, input_ids,
               text_mask, gen=None, tokens=None, *,
               longest=None, tp=None) -> torch.Tensor:
    """BiAttention + BiResNet over the image tokens and the encoded prompt,
    then the head. Question columns past the batch's longest prompt
    (``longest``, as for :func:`head_logits`) are masked (``q_valid``), so
    the bucket width does not change the answer: the reference pads to
    the longest row."""
    q_emb, img = _ban_features(params, cfg, images, input_ids, tokens)
    enc = t5_encode(params.t5, cfg.t5, q_emb, text_mask, tp=tp)
    if longest is None:
        longest = torch.amax(torch.sum(text_mask, dim=1))
    q_valid = (torch.arange(input_ids.shape[1], device=input_ids.device)
               < longest)[None, :].expand(input_ids.shape)
    att, _ = ban_ops.biattention_apply(params.ban.att, img, enc,
                                       q_valid=q_valid, gen=gen)
    fused = ban_ops.biresnet_apply(params.ban.res, img, enc, att,
                                   q_valid=q_valid, gen=gen)
    fused = dropout(fused, 0.1, gen)
    return dense(fused, params.head.weight, params.head.bias)


def ban_loss(params, cfg, images, input_ids, text_mask, class_labels,
             gen=None, tokens=None, *, longest=None,
             tp=None) -> torch.Tensor:
    return _class_ce(ban_logits(params, cfg, images, input_ids, text_mask,
                                gen, tokens, longest=longest, tp=tp),
                     class_labels)


def ban_predict(params, cfg, images, input_ids, text_mask,
                tokens=None, *, longest=None, tp=None) -> torch.Tensor:
    logits = ban_logits(params, cfg, images, input_ids, text_mask,
                        tokens=tokens, longest=longest, tp=tp)
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Variant dispatch
# ---------------------------------------------------------------------------


def _batch_visual(batch: Dict[str, torch.Tensor], cfg: MPRGenConfig):
    """(images, vision_tokens) of a batch in the compute dtype;
    ``vision_tokens`` (the cached frozen trunk) takes precedence."""
    dt = compute_dtype(cfg)
    images, tokens = batch.get("images"), batch.get("vision_tokens")
    return (None if images is None else images.to(dt),
            None if tokens is None else tokens.to(dt))


def loss_fn(params: MPRGen, cfg: MPRGenConfig,
            batch: Dict[str, torch.Tensor], gen=None,
            compute: Optional[MPRGen] = None, tp=None) -> torch.Tensor:
    """The training loss of a batch: images (B, 3, R, R) or vision_tokens
    (B, P, C) (neither for the text-only variant), input_ids, text_mask (B,
    L), and labels (B, T) for the generative variants or class_labels (B,)
    for the head variants (and, for them, an optional 0-d ``longest``:
    :func:`head_logits`). Runs on the compute-dtype copy of ``params``
    (``compute``, refreshed here; see :func:`cast_compute` for how its
    gradients are the masters'); ``tp`` runs T5 tensor-parallel."""
    if (compute is None and cfg.compute_dtype != "float32"
            and torch.is_grad_enabled()):
        raise ValueError(
            "loss_fn under autograd at a reduced compute dtype needs the "
            "compute copy whose gradients the caller reads (compute=)")
    params = cast_compute(params, cfg, out=compute)
    images, tokens = _batch_visual(batch, cfg)
    args = (params, cfg, images, batch["input_ids"], batch["text_mask"])
    if cfg.use_prediction_head:
        loss = ban_loss if cfg.use_ban else head_loss
        return loss(*args, batch["class_labels"], gen, tokens,
                    longest=batch.get("longest"), tp=tp)
    return generative_loss(*args, batch["labels"], gen, tokens, tp)


@torch.no_grad()
def variant_predict(params: MPRGen, cfg: MPRGenConfig,
                    batch: Dict[str, torch.Tensor],
                    max_new_tokens: int = 20, tp=None) -> torch.Tensor:
    """Greedy token ids (generative variants) or int32 class ids (head
    variants) of a batch, on parameters already in the compute dtype."""
    images, tokens = _batch_visual(batch, cfg)
    args = (params, cfg, images, batch["input_ids"], batch["text_mask"])
    if cfg.use_prediction_head:
        predict = ban_predict if cfg.use_ban else head_predict
        return predict(*args, tokens, longest=batch.get("longest"), tp=tp)
    return generative_predict(*args, max_new_tokens, tokens, tp)


def predict_fn(params: MPRGen, cfg: MPRGenConfig,
               batch: Dict[str, torch.Tensor], max_new_tokens: int = 20,
               compute: Optional[MPRGen] = None, tp=None) -> torch.Tensor:
    """:func:`variant_predict` on the fp32 masters (cast here, into
    ``compute`` when given)."""
    return variant_predict(cast_compute(params, cfg, out=compute), cfg,
                           batch, max_new_tokens, tp)
