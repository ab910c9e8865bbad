"""JAX params pytree / npz checkpoint -> the port's modules.

Counterpart of ``load_checkpoint`` in
``multimodalpromptretrieval_tpu/train/checkpoint.py``, and the one place
where layouts change:

  * JAX dense kernels are (in, out); the port's weights are (out, in);
  * JAX stacks each tower's layers on axis 0; the port has one module per
    layer;
  * CLIP's q/k/v are already one packed ``wqkv``; T5's separate q, k, v
    kernels are packed into one (3 * inner, d_model) ``qkv`` weight.

Leaves may be numpy arrays (including ``ml_dtypes`` bfloat16), anything
``numpy.asarray`` accepts, or torch tensors. The result is loaded with
``load_state_dict(strict=True)``, so a missing or misshapen leaf raises.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    MPRGen,
    MPRGenConfig,
)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # e.g. a view of a device array
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _t(x) -> torch.Tensor:
    """A dense kernel: (in, out) -> (out, in)."""
    return _tensor(x).transpose(-1, -2)


def _clip_blocks(blocks, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    n = _tensor(blocks["ln_1"]["w"]).shape[0]
    for i in range(n):
        p = f"{prefix}.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = _tensor(blocks[ln]["w"])[i]
            sd[p + ln + ".bias"] = _tensor(blocks[ln]["b"])[i]
        a, m = blocks["attn"], blocks["mlp"]
        sd[p + "attn.qkv.weight"] = _t(a["wqkv"])[i]
        sd[p + "attn.qkv.bias"] = _tensor(a["bqkv"])[i]
        sd[p + "attn.out.weight"] = _t(a["out"])[i]
        sd[p + "attn.out.bias"] = _tensor(a["out_b"])[i]
        sd[p + "mlp.fc.weight"] = _t(m["fc"])[i]
        sd[p + "mlp.fc.bias"] = _tensor(m["fc_b"])[i]
        sd[p + "mlp.proj.weight"] = _t(m["proj"])[i]
        sd[p + "mlp.proj.bias"] = _tensor(m["proj_b"])[i]


def _clip(tree, sd: Dict[str, torch.Tensor]) -> None:
    v, t = tree["visual"], tree["text"]
    sd["clip.visual.conv1.weight"] = _t(v["conv1"])
    sd["clip.visual.class_embedding"] = _tensor(v["class_embedding"])
    sd["clip.visual.pos_embedding"] = _tensor(v["pos_embedding"])
    for ln in ("ln_pre", "ln_post"):
        sd[f"clip.visual.{ln}.weight"] = _tensor(v[ln]["w"])
        sd[f"clip.visual.{ln}.bias"] = _tensor(v[ln]["b"])
    _clip_blocks(v["blocks"], "clip.visual.blocks", sd)
    sd["clip.visual.proj.weight"] = _t(v["proj"])
    sd["clip.text.token_embedding"] = _tensor(t["token_embedding"])
    sd["clip.text.pos_embedding"] = _tensor(t["pos_embedding"])
    _clip_blocks(t["blocks"], "clip.text.blocks", sd)
    sd["clip.text.ln_final.weight"] = _tensor(t["ln_final"]["w"])
    sd["clip.text.ln_final.bias"] = _tensor(t["ln_final"]["b"])
    sd["clip.text.text_projection.weight"] = _t(t["text_projection"])
    sd["clip.logit_scale"] = _tensor(tree["logit_scale"]).reshape(())


def _t5_attention(a, i: int, prefix: str,
                  sd: Dict[str, torch.Tensor]) -> None:
    sd[prefix + "qkv"] = torch.cat(
        [_t(a[name])[i] for name in ("q", "k", "v")], dim=0)
    sd[prefix + "o.weight"] = _t(a["o"])[i]


def _t5(tree, sd: Dict[str, torch.Tensor]) -> None:
    sd["t5.shared"] = _tensor(tree["shared"])
    for stack, attns, norms in (
            ("encoder", ("attn",), ("attn_ln", "ff_ln")),
            ("decoder", ("self_attn", "cross_attn"),
             ("self_ln", "cross_ln", "ff_ln"))):
        s = tree[stack]
        blk = s["block"]
        sd[f"t5.{stack}.rel_bias"] = _tensor(s["rel_bias"])
        sd[f"t5.{stack}.final_ln"] = _tensor(s["final_ln"])
        for i in range(_tensor(blk[norms[0]]).shape[0]):
            p = f"t5.{stack}.block.{i}."
            for a in attns:
                _t5_attention(blk[a], i, p + a + ".", sd)
            for ln in norms:
                sd[p + ln] = _tensor(blk[ln])[i]
            for name, w in blk["ff"].items():
                sd[p + f"ff.{name}.weight"] = _t(w)[i]


def params_from_jax(tree: Dict[str, Any], cfg: MPRGenConfig,
                    device: Optional[torch.device] = None) -> MPRGen:
    """The JAX package's params pytree (``init_mprgen`` / a loaded
    checkpoint) as the port's :class:`MPRGen` module."""
    sd: Dict[str, torch.Tensor] = {}
    _clip(tree["clip"], sd)
    _t5(tree["t5"], sd)
    if cfg.needs_projection:
        sd["proj.weight"] = _t(tree["proj"]["w"])
        sd["proj.bias"] = _tensor(tree["proj"]["b"])
    model = MPRGen(cfg)
    model.load_state_dict(sd, strict=True)
    return model.to(device) if device is not None else model


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def load_npz_checkpoint(path: str, cfg: MPRGenConfig,
                        device: Optional[torch.device] = None) -> MPRGen:
    """Load a checkpoint written by the JAX ``save_checkpoint``.

    bf16 leaves are stored as uint16 bits and listed under ``__bf16__``;
    they are viewed back as bf16 without ``ml_dtypes``. Optimizer state
    (``opt/...``) is not read: the port serves, it does not train yet."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    bf16 = set(json.loads(str(flat.pop("__bf16__")))) \
        if "__bf16__" in flat else set()
    params = {}
    for key, value in flat.items():
        if not key.startswith("params/"):
            continue
        if key in bf16:
            value = torch.from_numpy(value.view(np.int16)).view(
                torch.bfloat16)
        params[key[len("params/"):]] = value
    return params_from_jax(_nest(params), cfg, device)
