"""Config and file utilities shared by the experiments.

``get_model_prefix`` is the JAX package's (and the reference's) config ->
name mangling, character for character, so that checkpoint and log artifact
names are the same in both packages. ``savez_atomic`` writes the caches
that the processes of a group may write together.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def savez_atomic(path: str, **arrays) -> None:
    """``np.savez_compressed`` to ``path`` (".npz" appended, as numpy does)
    through a file of this process's own, renamed into place: processes
    that build one cache together never leave, or read, a torn file."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def get_model_prefix(cfg: Dict[str, Any]) -> str:
    data_name = cfg["dataset"]
    use_image_info = bool(cfg["use_image_info"])

    prefix = f"model_{data_name}"
    prefix += "_with_vision" if use_image_info else "_no_vision"
    prefix += ("_with_pretrained_checkpoint" if cfg.get("vision_checkpoint")
               else "_no_pretrained_checkpoint")
    if cfg.get("fewshot_training_tasks", {}) and \
            cfg["fewshot_training_tasks"].get("enabled"):
        prefix += "_fewshot"
    if cfg.get("mapping_checkpoint"):
        prefix += "_with_mapping"
    if cfg.get("use_prediction_head"):
        prefix += "_pred_head_BAN" if cfg.get("use_BAN") else "_pred_head"
    if cfg.get("freeze"):
        prefix += "_freeze"
    if cfg.get("retrieval"):
        prefix += "_retrieval"
    if "RN" in cfg.get("vision_encoder", ""):
        prefix += "_resnet"
    if "quantifier" in cfg and not cfg["quantifier"]:
        prefix += "_no_quantifier"
    return prefix
