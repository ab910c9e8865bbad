"""Checkpoints in the JAX package's npz format, over ``bridge.py``.

Counterpart of ``multimodalpromptretrieval_tpu/train/checkpoint.py``: the
params (and optionally the AdamW state) are laid out as the JAX pytrees
(``bridge.params_to_jax``), flattened to ``params/...`` and ``opt/...``
path-keyed arrays in one ``.npz``, with a sidecar JSON for the metadata
(``epoch``, ``valid_loss``, ``lr``, ``config``). bf16 leaves are stored as
uint16 bits and listed under ``__bf16__``; all-zero optimizer moments of
more than 1,024 elements (frozen parameters) are left out and listed under
``__elided_opt__``. A file written by either package loads in the other.

A mapping checkpoint (``create_mapping``'s output, the ``mapping_checkpoint``
config key) is the same format over the ``mapping`` subtree alone:
``params/fc1/w`` ... ``params/logit_scale``, as the JAX package's
``save_checkpoint(path, mapping_params)`` writes it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch import bridge
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    Mapping,
    MPRGen,
    MPRGenConfig,
)


def _flatten(tree, prefix=""):
    """``a/b/0/c`` keys, as the JAX package writes them (a list's items
    under their index)."""
    if isinstance(tree, list):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def save_mapping(path: str, mapping: Mapping) -> None:
    """The mapping MLP alone, in the JAX package's npz format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:  # at ``path`` itself, whatever its suffix
        np.savez(f, **{f"params/{k}": v.float().numpy() for k, v in
                       _flatten(bridge.mapping_to_jax(mapping)).items()})


def load_mapping_tree(path: str) -> Dict[str, Any]:
    """The ``mapping`` subtree of a mapping checkpoint written by either
    package, in the JAX layout (numpy leaves)."""
    with np.load(path, allow_pickle=False) as z:
        return _nest({k[len("params/"):]: z[k] for k in z.files
                      if k.startswith("params/")})


def save_checkpoint(path: str, params: MPRGen, cfg: MPRGenConfig,
                    opt_state: Optional[Dict[str, Any]] = None,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tensors = {f"params/{k}": v for k, v in
               _flatten(bridge.params_to_jax(params, cfg)).items()}
    arrays: Dict[str, np.ndarray] = {}
    if opt_state is not None:
        elided = []
        for k, v in _flatten(bridge.opt_state_to_jax(opt_state,
                                                     cfg)).items():
            # frozen parameters keep all-zero moments: leave them out, and
            # say so (a loader restores them from its template); small
            # leaves (the step counter) always stay
            if v.numel() > 1024 and not bool(v.any()):
                elided.append(k)
                continue
            tensors[f"opt/{k}"] = v
        arrays["__elided_opt__"] = np.asarray(json.dumps(elided))
    bf16_keys = []
    for k, v in tensors.items():
        if v.dtype == torch.bfloat16:  # npz has no bf16: the raw bits
            bf16_keys.append(k)
            v = v.contiguous().view(torch.int16)
            arrays[k] = v.numpy().view(np.uint16)
        else:
            arrays[k] = v.numpy()
    if bf16_keys:
        arrays["__bf16__"] = np.asarray(json.dumps(bf16_keys))
    np.savez(path, **arrays)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2)


def load_checkpoint(path: str, cfg: MPRGenConfig,
                    opt_template: Optional[Dict[str, Any]] = None,
                    device: Optional[torch.device] = None
                    ) -> Tuple[MPRGen, Optional[Dict[str, Any]],
                               Dict[str, Any]]:
    """(params, opt_state or None, metadata) from a checkpoint of either
    package. ``opt_template`` (an ``adamw_init`` state) asks for the
    optimizer state too: it supplies the left-out zero moments, and its
    dtype is authoritative (a bf16-moment file resumed under fp32 moments is
    cast up, and the reverse)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    bf16 = flat.pop("__bf16__", None)
    for k in (json.loads(str(bf16)) if bf16 is not None else ()):
        flat[k] = torch.from_numpy(flat[k].view(np.int16)).view(
            torch.bfloat16)
    marker = flat.pop("__elided_opt__", None)
    elided = set(json.loads(str(marker))) if marker is not None else set()
    pflat = {k[len("params/"):]: v for k, v in flat.items()
             if k.startswith("params/")}
    try:
        params = bridge.params_from_jax(_nest(pflat), cfg, device)
    except KeyError as e:
        raise ValueError(
            f"checkpoint {path} does not match the model: parameter "
            f"{e.args[0]!r} is missing from the file. Was it written by a "
            "different T5_version / model variant?") from e
    opt_state = None
    oflat = {k[len("opt/"):]: v for k, v in flat.items()
             if k.startswith("opt/")}
    if opt_template is not None and oflat:
        zeros = _flatten(bridge.opt_state_to_jax(opt_template, cfg))
        for k in elided:
            oflat[k] = torch.zeros_like(zeros[k])
        loaded = bridge.opt_state_from_jax(_nest(oflat), cfg, device)
        for kind in ("mu", "nu"):
            for name, t in opt_template[kind].items():
                loaded[kind][name] = loaded[kind][name].to(t.dtype)
        opt_state = loaded
    metadata: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            metadata = json.load(f)
    return params, opt_state, metadata
