"""Config utilities shared by the training experiment.

``get_model_prefix`` is the JAX package's (and the reference's) config ->
name mangling, character for character, so that checkpoint and log artifact
names are the same in both packages.
"""

from __future__ import annotations

from typing import Any, Dict


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
