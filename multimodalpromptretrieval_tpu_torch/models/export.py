"""Checkpoint exporters: the JAX package's tree layout -> torch state dicts.

Counterpart of ``multimodalpromptretrieval_tpu/models/export.py``, the
inverse of ``models/convert.py``: a model trained here loads into the
reference (``model.load_state_dict(checkpoint['model_state_dict'])``), into
HF ``T5ForConditionalGeneration`` or into ``clip.load``-style code.

Each exporter takes the params tree in the JAX package's layout, as the
port holds it with ``bridge.tree_numpy(bridge.params_to_jax(model, cfg))``,
and returns ``{name: np.ndarray}``; callers wrap the arrays in tensors.
Export -> convert is the identity.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np

from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config

Tree = Dict[str, Any]


def _n(x) -> np.ndarray:
    return np.asarray(x)


def _nt(x) -> np.ndarray:
    """The tree's (in, out) kernels -> torch's (out, in)."""
    return np.ascontiguousarray(np.asarray(x).T)


def _unstack(tree) -> List[Tree]:
    """A tree whose leaves stack layers on axis 0 -> one tree per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(np.asarray(tree))


# ---------------------------------------------------------------------------
# T5 -> HF layout
# ---------------------------------------------------------------------------


def t5_to_hf(params: Mapping[str, Any],
             cfg: T5Config) -> Dict[str, np.ndarray]:
    """The ``t5`` tree -> HF ``T5ForConditionalGeneration`` state dict,
    with the tied copies HF carries (``encoder`` / ``decoder.embed_tokens``
    and ``lm_head`` are ``shared``: the head is always tied here)."""
    gated = cfg.feed_forward_proj == "gated-gelu"
    sd: Dict[str, np.ndarray] = {}

    def put_attn(prefix, a):
        for k in "qkvo":
            sd[f"{prefix}.{k}.weight"] = _nt(a[k])

    def put_ff(prefix, f):
        for k in (("wi_0", "wi_1") if gated else ("wi",)) + ("wo",):
            sd[f"{prefix}.{k}.weight"] = _nt(f[k])

    shared = _n(params["shared"])
    for k in ("shared", "encoder.embed_tokens", "decoder.embed_tokens",
              "lm_head"):
        sd[f"{k}.weight"] = shared
    for i, layer in enumerate(_unstack(params["encoder"]["block"])):
        b = f"encoder.block.{i}.layer"
        put_attn(f"{b}.0.SelfAttention", layer["attn"])
        sd[f"{b}.0.layer_norm.weight"] = _n(layer["attn_ln"])
        put_ff(f"{b}.1.DenseReluDense", layer["ff"])
        sd[f"{b}.1.layer_norm.weight"] = _n(layer["ff_ln"])
    for i, layer in enumerate(_unstack(params["decoder"]["block"])):
        b = f"decoder.block.{i}.layer"
        put_attn(f"{b}.0.SelfAttention", layer["self_attn"])
        sd[f"{b}.0.layer_norm.weight"] = _n(layer["self_ln"])
        put_attn(f"{b}.1.EncDecAttention", layer["cross_attn"])
        sd[f"{b}.1.layer_norm.weight"] = _n(layer["cross_ln"])
        put_ff(f"{b}.2.DenseReluDense", layer["ff"])
        sd[f"{b}.2.layer_norm.weight"] = _n(layer["ff_ln"])
    for stack in ("encoder", "decoder"):
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias"
           ".weight"] = _n(params[stack]["rel_bias"])
        sd[f"{stack}.final_layer_norm.weight"] = _n(params[stack]["final_ln"])
    return sd


# ---------------------------------------------------------------------------
# CLIP -> OpenAI layout
# ---------------------------------------------------------------------------


def _put_openai_block(sd, prefix: str, b) -> None:
    for ln in ("ln_1", "ln_2"):
        sd[f"{prefix}.{ln}.weight"] = _n(b[ln]["w"])
        sd[f"{prefix}.{ln}.bias"] = _n(b[ln]["b"])
    sd[f"{prefix}.attn.in_proj_weight"] = _nt(b["attn"]["wqkv"])
    sd[f"{prefix}.attn.in_proj_bias"] = _n(b["attn"]["bqkv"])
    sd[f"{prefix}.attn.out_proj.weight"] = _nt(b["attn"]["out"])
    sd[f"{prefix}.attn.out_proj.bias"] = _n(b["attn"]["out_b"])
    sd[f"{prefix}.mlp.c_fc.weight"] = _nt(b["mlp"]["fc"])
    sd[f"{prefix}.mlp.c_fc.bias"] = _n(b["mlp"]["fc_b"])
    sd[f"{prefix}.mlp.c_proj.weight"] = _nt(b["mlp"]["proj"])
    sd[f"{prefix}.mlp.c_proj.bias"] = _n(b["mlp"]["proj_b"])


def clip_to_openai(params: Mapping[str, Any], cfg) -> Dict[str, np.ndarray]:
    """The ``clip`` tree -> OpenAI ``clip.load`` state dict."""
    v, t = params["visual"], params["text"]
    sd: Dict[str, np.ndarray] = {}
    conv = _n(v["conv1"])  # (3 * p^2, width)
    p = cfg.patch_size
    sd["visual.conv1.weight"] = np.ascontiguousarray(
        conv.T.reshape(conv.shape[1], 3, p, p))
    sd["visual.class_embedding"] = _n(v["class_embedding"])
    sd["visual.positional_embedding"] = _n(v["pos_embedding"])
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = _n(v[ln]["w"])
        sd[f"visual.{ln}.bias"] = _n(v[ln]["b"])
    for i, b in enumerate(_unstack(v["blocks"])):
        _put_openai_block(sd, f"visual.transformer.resblocks.{i}", b)
    sd["visual.proj"] = _n(v["proj"])
    sd["token_embedding.weight"] = _n(t["token_embedding"])
    sd["positional_embedding"] = _n(t["pos_embedding"])
    for i, b in enumerate(_unstack(t["blocks"])):
        _put_openai_block(sd, f"transformer.resblocks.{i}", b)
    sd["ln_final.weight"] = _n(t["ln_final"]["w"])
    sd["ln_final.bias"] = _n(t["ln_final"]["b"])
    sd["text_projection"] = _n(t["text_projection"])
    sd["logit_scale"] = _n(params["logit_scale"])
    return sd


# ---------------------------------------------------------------------------
# A whole model -> the reference's T5VisionModel* state dict
# ---------------------------------------------------------------------------


def _put_wn_linear(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight_v"] = _nt(p["v"])
    sd[f"{prefix}.weight_g"] = _n(p["g"]).reshape(())
    sd[f"{prefix}.bias"] = _n(p["b"])


def _put_fcnet(sd, prefix: str, layers) -> None:
    """The reference's FCNet puts each weight-normed Linear after a Dropout:
    at index 1 of each [Dropout, Linear, Act?] group."""
    for j, p in enumerate(layers):
        _put_wn_linear(sd, f"{prefix}.main.{3 * j + 1}", p)


def _put_bcnet(sd, prefix: str, p, with_hmat: bool) -> None:
    _put_fcnet(sd, f"{prefix}.v_net", p["v_net"])
    _put_fcnet(sd, f"{prefix}.q_net", p["q_net"])
    if with_hmat:
        sd[f"{prefix}.h_mat_v"] = _n(p["h_mat"]["v"])
        sd[f"{prefix}.h_mat_g"] = _n(p["h_mat"]["g"]).reshape(())
        sd[f"{prefix}.h_bias"] = _n(p["h_bias"])


def mprgen_to_reference_state_dict(params: Mapping[str, Any],
                                   cfg) -> Dict[str, np.ndarray]:
    """The params tree -> the reference's T5VisionModel* state dict (the
    inverse of ``convert.mprgen_from_reference_checkpoint``). An RN model
    exports its ViT under ``vision_model.``, not its ResNet, as the JAX
    package does; ``rn_proj`` is its ``projection``."""
    sd: Dict[str, np.ndarray] = {}
    for k, v in t5_to_hf(params["t5"], cfg.t5).items():
        sd[f"T5_model.{k}"] = v
    for k, v in clip_to_openai(params["clip"], cfg.clip).items():
        sd[f"vision_model.{k}"] = v
    for key in ("proj", "rn_proj"):
        if key in params:
            sd["projection.weight"] = _nt(params[key]["w"])
            sd["projection.bias"] = _n(params[key]["b"])
    if params.get("mapping"):
        m, s = params["mapping"], "mapping.linear_relu_stack"
        for i, fc in ((0, "fc1"), (2, "fc2")):
            sd[f"{s}.{i}.weight"] = _nt(m[fc]["w"])
            sd[f"{s}.{i}.bias"] = _n(m[fc]["b"])
        sd["mapping.logit_scale"] = _n(m["logit_scale"]).reshape(())
    if "head" in params:
        sd["prediction_head.weight"] = _nt(params["head"]["w"])
        sd["prediction_head.bias"] = _n(params["head"]["b"])
    if "ban" in params:
        ban = params["ban"]
        _put_bcnet(sd, "BAN_att.logits", ban["att"]["logits"], True)
        for g, p in enumerate(ban["res"]["b_net"]):
            _put_bcnet(sd, f"BAN_resnet.b_net.{g}", p, False)
        for g, p in enumerate(ban["res"]["q_prj"]):
            _put_fcnet(sd, f"BAN_resnet.q_prj.{g}", p)
    return sd
