"""Checkpoint converters: torch state dicts -> the JAX package's tree layout.

Counterpart of ``multimodalpromptretrieval_tpu/models/convert.py``, for the
external weights the reference loads:

  * HF ``T5ForConditionalGeneration`` (t5-small and its kin, relu or
    gated-gelu feed-forward);
  * OpenAI CLIP (``clip.load``; PubMedCLIP's ``ckpt['state_dict']`` has the
    same layout under a ``visual_encoder.`` prefix) and HF ``CLIPModel``,
    whose separate q / k / v are packed into one qkv here;
  * a whole reference model (``torch.save`` of the T5VisionModel* state
    dict), every branch: T5, the ViT or the ResNet, the projection, the
    mapping, the head and the weight-normed BAN fusion.

Each converter takes ``{name: array}`` (``state_dict_to_numpy`` turns a
torch state dict into one) and returns the JAX package's params tree as
float32 numpy on the host, layers stacked on axis 0 and dense kernels
(in, out): ``bridge.params_from_jax`` makes the port's module of it, so one
name map holds the layout. Nothing here touches a device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch import bridge
from multimodalpromptretrieval_tpu_torch.models.clip import CLIP, CLIPConfig
from multimodalpromptretrieval_tpu_torch.models.resnet import (
    resnet_from_openai,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config

Tree = Dict[str, Any]


def state_dict_to_numpy(state_dict: Mapping[str, Any]
                        ) -> Dict[str, np.ndarray]:
    """torch state dict -> {name: np.ndarray} (detached, on the host,
    fp32)."""
    out = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


def _a(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(x) -> np.ndarray:
    """torch's (out, in) -> the JAX tree's (in, out)."""
    return np.ascontiguousarray(_a(x).T)


def _scalar(x) -> np.ndarray:
    return _a(x).reshape(())


def _stack(trees: List[Tree]) -> Tree:
    """Per-layer trees -> one tree whose leaves stack the layers."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


# ---------------------------------------------------------------------------
# T5 (HF layout)
# ---------------------------------------------------------------------------


def t5_from_hf(sd: Mapping[str, np.ndarray], cfg: T5Config) -> Tree:
    """HF ``T5ForConditionalGeneration`` state dict -> the ``t5`` tree. The
    tied copies (``encoder.embed_tokens``, ``decoder.embed_tokens``,
    ``lm_head``) are not read: ``shared.weight`` is the one matrix."""
    gated = cfg.feed_forward_proj == "gated-gelu"

    def attn(prefix):
        return {k: _t(sd[f"{prefix}.{k}.weight"]) for k in "qkvo"}

    def ff(prefix):
        names = ("wi_0", "wi_1", "wo") if gated else ("wi", "wo")
        return {k: _t(sd[f"{prefix}.{k}.weight"]) for k in names}

    enc = []
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        enc.append({"attn": attn(f"{b}.0.SelfAttention"),
                    "attn_ln": _a(sd[f"{b}.0.layer_norm.weight"]),
                    "ff": ff(f"{b}.1.DenseReluDense"),
                    "ff_ln": _a(sd[f"{b}.1.layer_norm.weight"])})
    dec = []
    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}.layer"
        dec.append({"self_attn": attn(f"{b}.0.SelfAttention"),
                    "self_ln": _a(sd[f"{b}.0.layer_norm.weight"]),
                    "cross_attn": attn(f"{b}.1.EncDecAttention"),
                    "cross_ln": _a(sd[f"{b}.1.layer_norm.weight"]),
                    "ff": ff(f"{b}.2.DenseReluDense"),
                    "ff_ln": _a(sd[f"{b}.2.layer_norm.weight"])})

    def stack(name, layers):
        return {"block": _stack(layers),
                "rel_bias": _a(sd[f"{name}.block.0.layer.0.SelfAttention"
                                  ".relative_attention_bias.weight"]),
                "final_ln": _a(sd[f"{name}.final_layer_norm.weight"])}

    return {"shared": _a(sd["shared.weight"]),
            "encoder": stack("encoder", enc),
            "decoder": stack("decoder", dec)}


def resize_token_embeddings(tree: Tree, new_size: int,
                            seed: int = 0) -> Tree:
    """HF ``resize_token_embeddings`` on the tied ``shared`` matrix: the
    reference adds one "[itk]" token and resizes to the tokenizer's length,
    which for t5-small SHRINKS 32,128 -> 32,101 rows, keeping the leading
    ones. Grown rows are N(0, 1), drawn from a generator seeded with
    ``seed`` (the JAX package draws its own: only the kept rows agree)."""
    shared = tree["shared"]
    old = shared.shape[0]
    if new_size <= old:
        shared = shared[:new_size]
    else:
        gen = torch.Generator().manual_seed(seed)
        extra = torch.randn((new_size - old, shared.shape[1]),
                            generator=gen).numpy().astype(shared.dtype)
        shared = np.concatenate([shared, extra], axis=0)
    return dict(tree, shared=shared)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def clip_config_from_openai_sd(sd: Mapping[str, np.ndarray]) -> CLIPConfig:
    """The CLIPConfig of an OpenAI-layout state dict (as ``clip.load``
    infers it)."""
    patch = sd["visual.conv1.weight"].shape[2]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * patch,
        vision_width=sd["visual.conv1.weight"].shape[0],
        vision_layers=len({k.split(".")[3] for k in sd
                           if k.startswith("visual.transformer.resblocks.")}),
        patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=sd["positional_embedding"].shape[1],
        text_layers=len({k.split(".")[2] for k in sd
                         if k.startswith("transformer.resblocks.")}))


def _ln(sd, prefix: str) -> Tree:
    return {"w": _a(sd[f"{prefix}.weight"]), "b": _a(sd[f"{prefix}.bias"])}


def _block(sd, prefix: str, names: Mapping[str, str], wqkv, bqkv) -> Tree:
    """One residual block; ``names`` maps the JAX tree's parts to the
    checkpoint's module names."""
    return {
        "ln_1": _ln(sd, f"{prefix}.{names['ln_1']}"),
        "attn": {"wqkv": _t(wqkv), "bqkv": _a(bqkv),
                 "out": _t(sd[f"{prefix}.{names['out']}.weight"]),
                 "out_b": _a(sd[f"{prefix}.{names['out']}.bias"])},
        "ln_2": _ln(sd, f"{prefix}.{names['ln_2']}"),
        "mlp": {"fc": _t(sd[f"{prefix}.{names['fc']}.weight"]),
                "fc_b": _a(sd[f"{prefix}.{names['fc']}.bias"]),
                "proj": _t(sd[f"{prefix}.{names['proj']}.weight"]),
                "proj_b": _a(sd[f"{prefix}.{names['proj']}.bias"])},
    }


_OPENAI = {"ln_1": "ln_1", "ln_2": "ln_2", "out": "attn.out_proj",
           "fc": "mlp.c_fc", "proj": "mlp.c_proj"}
_HF = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
       "out": "self_attn.out_proj", "fc": "mlp.fc1", "proj": "mlp.fc2"}


def _openai_block(sd, prefix: str) -> Tree:
    return _block(sd, prefix, _OPENAI, sd[f"{prefix}.attn.in_proj_weight"],
                  sd[f"{prefix}.attn.in_proj_bias"])


def _hf_block(sd, prefix: str) -> Tree:
    a = f"{prefix}.self_attn"
    return _block(
        sd, prefix, _HF,
        np.concatenate([sd[f"{a}.{x}_proj.weight"] for x in "qkv"], axis=0),
        np.concatenate([sd[f"{a}.{x}_proj.bias"] for x in "qkv"]))


def _patch_kernel(conv) -> np.ndarray:
    """(width, 3, p, p) conv -> the (3 * p^2, width) patch matrix."""
    conv = _a(conv)
    return np.ascontiguousarray(conv.reshape(conv.shape[0], -1).T)


def clip_from_openai(sd: Mapping[str, np.ndarray], cfg: CLIPConfig) -> Tree:
    """OpenAI ``clip.load`` / PubMedCLIP ``ckpt['state_dict']`` layout ->
    the ``clip`` tree."""
    return {
        "visual": {
            "conv1": _patch_kernel(sd["visual.conv1.weight"]),
            "class_embedding": _a(sd["visual.class_embedding"]),
            "pos_embedding": _a(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _stack([
                _openai_block(sd, f"visual.transformer.resblocks.{i}")
                for i in range(cfg.vision_layers)]),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _a(sd["visual.proj"]),
        },
        "text": {
            "token_embedding": _a(sd["token_embedding.weight"]),
            "pos_embedding": _a(sd["positional_embedding"]),
            "blocks": _stack([
                _openai_block(sd, f"transformer.resblocks.{i}")
                for i in range(cfg.text_layers)]),
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": _a(sd["text_projection"]),
        },
        "logit_scale": _a(sd["logit_scale"]),
    }


def clip_from_hf(sd: Mapping[str, np.ndarray], cfg: CLIPConfig) -> Tree:
    """HF ``CLIPModel`` layout (the same architecture as OpenAI CLIP under
    ``hidden_act="quick_gelu"``) -> the ``clip`` tree."""
    v, t = "vision_model", "text_model"
    return {
        "visual": {
            "conv1": _patch_kernel(
                sd[f"{v}.embeddings.patch_embedding.weight"]),
            "class_embedding": _a(sd[f"{v}.embeddings.class_embedding"]),
            "pos_embedding": _a(
                sd[f"{v}.embeddings.position_embedding.weight"]),
            "ln_pre": _ln(sd, f"{v}.pre_layrnorm"),
            "blocks": _stack([_hf_block(sd, f"{v}.encoder.layers.{i}")
                              for i in range(cfg.vision_layers)]),
            "ln_post": _ln(sd, f"{v}.post_layernorm"),
            "proj": _t(sd["visual_projection.weight"]),
        },
        "text": {
            "token_embedding": _a(
                sd[f"{t}.embeddings.token_embedding.weight"]),
            "pos_embedding": _a(
                sd[f"{t}.embeddings.position_embedding.weight"]),
            "blocks": _stack([_hf_block(sd, f"{t}.encoder.layers.{i}")
                              for i in range(cfg.text_layers)]),
            "ln_final": _ln(sd, f"{t}.final_layer_norm"),
            "text_projection": _t(sd["text_projection.weight"]),
        },
        "logit_scale": _a(sd["logit_scale"]),
    }


# ---------------------------------------------------------------------------
# A whole reference model (the drop-in migration path)
# ---------------------------------------------------------------------------


def _wn_linear_from(sd, prefix: str) -> Tree:
    """``weight_norm(nn.Linear, dim=None)``: a scalar ``weight_g`` and an
    (out, in) ``weight_v`` -> {v (in, out), g, b}."""
    return {"v": _t(sd[f"{prefix}.weight_v"]),
            "g": _scalar(sd[f"{prefix}.weight_g"]),
            "b": _a(sd[f"{prefix}.bias"])}


def _fcnet_from(sd, prefix: str) -> List[Tree]:
    """The one weight-normed Linear of an FCNet; with dropout it sits at an
    odd index of ``main`` ([Dropout, Linear, Act?]), so it is found by
    key."""
    for i in range(16):
        if f"{prefix}.main.{i}.weight_v" in sd:
            return [_wn_linear_from(sd, f"{prefix}.main.{i}")]
    return []


def _bcnet_from(sd, prefix: str, with_hmat: bool) -> Tree:
    p = {"v_net": _fcnet_from(sd, f"{prefix}.v_net"),
         "q_net": _fcnet_from(sd, f"{prefix}.q_net")}
    if with_hmat:
        p["h_mat"] = {"v": _a(sd[f"{prefix}.h_mat_v"]),
                      "g": _scalar(sd[f"{prefix}.h_mat_g"])}
        p["h_bias"] = _a(sd[f"{prefix}.h_bias"])
    return p


def _sub(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def mprgen_from_reference_checkpoint(sd: Mapping[str, np.ndarray],
                                     cfg) -> Tree:
    """A saved reference model (``vision_model.*`` OpenAI CLIP or
    ModifiedResNet, ``T5_model.*`` HF T5, ``projection.*``, ``mapping.*``,
    ``prediction_head.*``, ``BAN_att.*`` / ``BAN_resnet.*``) -> the params
    tree of the parts the file holds. ``cfg``: the
    :class:`~models.mprgen.MPRGenConfig` of the checkpoint's variant.

    The reference's RN model holds no ViT, which the retrieval queries
    still need (quirk #2): that case carries a random ViT drawn from a
    generator seeded with 0, as the JAX package draws one from its key 0
    (the two draws differ)."""
    params: Tree = {"t5": t5_from_hf(_sub(sd, "T5_model."), cfg.t5)}
    vision = _sub(sd, "vision_model.")
    if "visual.layer1.0.conv1.weight" in vision:
        params["clip_rn"] = resnet_from_openai(vision, cfg.resnet)
        params["clip"] = _seeded_clip(cfg.clip, 0)
    else:
        params["clip"] = clip_from_openai(vision, cfg.clip)
    if "projection.weight" in sd:
        params["rn_proj" if cfg.resnet is not None else "proj"] = {
            "w": _t(sd["projection.weight"]), "b": _a(sd["projection.bias"])}
    m = "mapping.linear_relu_stack"
    if f"{m}.0.weight" in sd:
        params["mapping"] = {
            "fc1": {"w": _t(sd[f"{m}.0.weight"]), "b": _a(sd[f"{m}.0.bias"])},
            "fc2": {"w": _t(sd[f"{m}.2.weight"]), "b": _a(sd[f"{m}.2.bias"])},
            "logit_scale": _scalar(sd["mapping.logit_scale"])}
    if "prediction_head.weight" in sd:
        params["head"] = {"w": _t(sd["prediction_head.weight"]),
                          "b": _a(sd["prediction_head.bias"])}
    if "BAN_att.logits.h_mat_v" in sd:
        glimpse = sd["BAN_att.logits.h_mat_v"].shape[1]
        params["ban"] = {
            "att": {"logits": _bcnet_from(sd, "BAN_att.logits", True)},
            "res": {"b_net": [_bcnet_from(sd, f"BAN_resnet.b_net.{g}", False)
                              for g in range(glimpse)],
                    "q_prj": [_fcnet_from(sd, f"BAN_resnet.q_prj.{g}")
                              for g in range(glimpse)]}}
    return params


def _seeded_clip(cfg: CLIPConfig, seed: int) -> Tree:
    """A seeded random CLIP as the ``clip`` tree (numpy)."""
    holder = torch.nn.Module()
    holder.clip = CLIP(cfg, torch.Generator().manual_seed(seed))
    return bridge.tree_numpy(bridge.tensors_to_jax(
        dict(holder.named_parameters()), None,
        bridge.clip_leaves(cfg)))["clip"]
