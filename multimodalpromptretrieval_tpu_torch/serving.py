"""Config -> model, tokenizers and retrieval index, for serving.

The serving half of ``Experiment`` (``multimodalpromptretrieval_tpu/
train/experiment.py``), read from the same JSON config keys: ``T5_version``,
``t5_overrides``, ``clip_overrides``, ``compute_dtype``, ``retrieval``,
``k``, ``quantifier``, ``hyperparameters.batch_size``,
``max_source_length``, ``seed``, ``spiece_model`` / ``clip_bpe``.

Data comes in memory: QA entries (the dataset parsers' dict schema) and
preprocessed images (3, R, R) keyed by image name. Reading SLAKE from disk
needs PIL and ``ops/image.clip_preprocess``, which are not ported yet.
:func:`synthetic_slake` builds such data from a seed with numpy alone,
:func:`synthetic_config` a tiny config for it, and :func:`north_star_setup`
the full-width serving load that ``chip_smoke.py`` drives.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import random
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.data import synthetic
from multimodalpromptretrieval_tpu_torch.models.clip import (
    IMAGE_MEAN,
    IMAGE_STD,
    CLIPConfig,
    clip_encode_image,
    clip_encode_text,
    truncate_text_ids,
)
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    MPRGen,
    MPRGenConfig,
    init_mprgen,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config
from multimodalpromptretrieval_tpu_torch.retrieval.index import RetrievalIndex
from multimodalpromptretrieval_tpu_torch.text import (
    CLIPBPETokenizer,
    T5SentencePieceTokenizer,
)

# config keys of disk-dataset features this slice does not serve yet
_UNPORTED_KEYS = ("retrieval_dataset", "retrieval_subset",
                  "use_additional_retrieval_data", "mapping_checkpoint",
                  "reference_checkpoint", "t5_checkpoint",
                  "vision_checkpoint", "clip_checkpoint")


def resolve_device(device) -> torch.device:
    """The device of an entry point: ``None`` means the card, and raises
    when there is none; the CPU is used only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "called with device=\"cpu\"")
    return torch.device("cuda")


def tokenizer_corpus(train: Sequence[dict], validate: Sequence[dict],
                     test: Sequence[dict]) -> List[str]:
    """The hermetic-tokenizer training corpus (as the JAX Experiment
    builds it from its three splits)."""
    corpus = [e["question"] for e in train]
    corpus += [e["answer"] for e in train]
    corpus += [e["answer"] for e in validate]
    corpus += [e["answer"] for e in test]
    corpus += [f"Answer the {t} question: " for t in sorted(
        {e["task"] for e in train})]
    corpus += ["I believe the answer is", "The most frequent answer",
               "very unlikely unlikely maybe likely very likely "
               "certainly"]
    return corpus


class ServingExperiment:
    """What :class:`~multimodalpromptretrieval_tpu_torch.serve.MPRServer`
    needs: ``model_cfg``, ``params`` (fp32 master :class:`MPRGen`),
    ``tokenizer``, ``clip_tokenizer``, ``retrieval_index``, ``batch_size``,
    ``k`` and ``use_quantifier``.

    ``params``: given (e.g. ``bridge.params_from_jax``) or, when None, a
    seeded random init from the config's ``seed``. ``device=None`` is the
    card (:func:`resolve_device`). ``train_mode`` builds the retrieval
    index in its training phase (the nearest neighbour, the query itself,
    is dropped); :class:`~multimodalpromptretrieval_tpu_torch.train.
    experiment.TrainingExperiment` builds on this class.
    """

    def __init__(self, cfg: Dict[str, Any], *, train: Sequence[dict],
                 validate: Sequence[dict] = (), test: Sequence[dict] = (),
                 images: Mapping[str, np.ndarray],
                 params: Optional[MPRGen] = None,
                 device: Optional[torch.device] = None,
                 train_mode: bool = False):
        used = [k for k in _UNPORTED_KEYS if cfg.get(k)]
        if used or "RN" in cfg.get("vision_encoder", ""):
            raise NotImplementedError(
                f"config keys {used or ['vision_encoder=RN*']} need the "
                "disk-dataset / variant paths that are not ported yet "
                "(ROADMAP A9, A10)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.images = images
        self.splits = {"train": list(train), "validate": list(validate),
                       "test": list(test)}

        spiece = cfg.get("spiece_model")
        if spiece and os.path.exists(spiece):
            self.tokenizer = T5SentencePieceTokenizer.from_spiece_model(
                spiece)
        else:
            self.tokenizer = T5SentencePieceTokenizer.from_corpus(
                tokenizer_corpus(train, validate, test))
        # the reference adds one "[itk]" token (T5VisionModel.py:58-61)
        self.tokenizer.add_tokens(["[itk]"])

        t5_cfg = T5Config.from_version(cfg.get("T5_version", "t5-small"))
        if cfg.get("t5_overrides"):
            t5_cfg = dataclasses.replace(t5_cfg, **cfg["t5_overrides"])
        clip_cfg = CLIPConfig.vit_b32()
        if cfg.get("clip_overrides"):
            clip_cfg = dataclasses.replace(clip_cfg, **cfg["clip_overrides"])
        if len(self.tokenizer) > t5_cfg.vocab_size:
            # an id past the embedding table would index out of range
            raise ValueError(
                f"tokenizer has {len(self.tokenizer)} ids but the T5 "
                f"embedding has only {t5_cfg.vocab_size} rows; raise "
                "t5_overrides.vocab_size (or shrink the tokenizer corpus)")
        merges = cfg.get("clip_bpe")
        if merges and os.path.exists(merges):
            self.clip_tokenizer = CLIPBPETokenizer.from_merges_file(
                merges, context_length=clip_cfg.context_length)
        else:
            self.clip_tokenizer = CLIPBPETokenizer.build_toy(
                context_length=clip_cfg.context_length)
        self.model_cfg = MPRGenConfig(
            t5=t5_cfg, clip=clip_cfg,
            use_image_info=bool(cfg["use_image_info"]),
            use_prediction_head=bool(cfg.get("use_prediction_head")),
            use_ban=bool(cfg.get("use_BAN")),
            freeze=bool(cfg.get("freeze")),
            max_source_length=cfg.get("max_source_length", 512),
            max_target_length=cfg.get("max_target_length", 128),
            compute_dtype=cfg.get("compute_dtype", "float32"))
        self.params = (params.to(self.device) if params is not None
                       else init_mprgen(self.model_cfg, cfg.get("seed", 88),
                                        self.device))

        self.batch_size = cfg["hyperparameters"]["batch_size"]
        self.k = cfg.get("k", 15)
        self.use_quantifier = not ("quantifier" in cfg
                                   and not cfg["quantifier"])
        self.retrieval_index: Optional[RetrievalIndex] = None
        if cfg.get("retrieval"):
            self.retrieval_index = RetrievalIndex.build(
                self._clip_embed, list(train),
                lambda names: np.stack([images[n] for n in names]),
                self.clip_tokenizer.tokenize, batch_size=self.batch_size,
                is_training_phase=train_mode, retrieval_k=self.k,
                device=self.device)

    @torch.inference_mode()
    def _clip_embed(self, images: np.ndarray,
                    text_ids: np.ndarray) -> torch.Tensor:
        """CLIP image (+) text embedding with the fp32 master params."""
        clip, cfg = self.params.clip, self.model_cfg.clip
        imgs = torch.as_tensor(np.asarray(images, np.float32),
                               device=self.device)
        ids = torch.as_tensor(truncate_text_ids(text_ids), device=self.device)
        return torch.cat([clip_encode_image(clip, cfg, imgs),
                          clip_encode_text(clip, cfg, ids)], dim=1)


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    """(R, R, 3) uint8 -> (3, R, R) float32 with CLIP's mean / std (no
    resize: the image is drawn at the tower's resolution)."""
    x = rgb.astype(np.float32) / 255.0
    x = (x - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(IMAGE_STD,
                                                             np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def synthetic_slake(n_train: int, n_test: int, *, image_size: int,
                    seed: int = 0, answer_style: str = "short",
                    n_validate: int = 0
                    ) -> Tuple[Dict[str, List[dict]], Dict[str, np.ndarray]]:
    """The synthetic SLAKE corpus of ``data/synthetic.generate_synthetic_
    slake`` (same draws from ``seed``), built in memory: entries in the
    parsed dataset schema per split, and CLIP-normalized images by name."""
    rng = random.Random(seed)
    splits: Dict[str, List[dict]] = {}
    images: Dict[str, np.ndarray] = {}
    qid = img_id = 0
    for split, n in (("train", n_train), ("validate", n_validate),
                     ("test", n_test)):
        entries = []
        for _ in range(n):
            shape = rng.choice(synthetic._SHAPES)
            color = rng.choice(sorted(synthetic._COLORS))
            count = rng.randint(1, 3)
            name = f"synthetic_{img_id:05d}.png"
            img_id += 1
            images[name] = normalize_image(synthetic._draw(
                shape, synthetic._COLORS[color], count, image_size, rng))
            if answer_style == "open":
                qa = synthetic._open_qa(shape, color, count, rng)
            else:
                probe = rng.choice(synthetic._SHAPES)
                qa = [("what shape is shown in the image?", shape, "Shape",
                       "open"),
                      (f"what color is the {shape}?", color, "Color",
                       "open"),
                      (f"is there a {probe} in the image?",
                       "yes" if probe == shape else "no", "Presence",
                       "closed")]
            for question, answer, task, atype in qa:
                entries.append({"image_name": name,
                                "question_id": str(qid),
                                "question": question.lower(),
                                "answer": answer.lower(), "task": task,
                                "question_type": atype})
                qid += 1
        splits[split] = entries
    return splits, images


def synthetic_config(**kw) -> dict:
    """The config of ``data/synthetic.synthetic_config`` (same keyword
    arguments) without its dataset paths: tiny t5 / clip overrides that
    serve and train on the CPU in seconds."""
    cfg = synthetic.synthetic_config("", **kw)
    del cfg["datafolder"], cfg["retrieval_cache_dir"]
    return cfg


# the t5_overrides / clip_overrides of the full-width serving paths that
# chip_smoke.py drives and profile_serve.py measures. "main": the north-star
# config (row attention, the default indicator decode; kernels K1-K4, K7).
# "pallas": flash attention in both towers and the encoder, the "pallas"
# decode (K8, K6, K4).
SERVE_PATHS = {
    "main": dict(t5_overrides={"attention_impl": "row"},
                 clip_overrides={"attention_impl": "row"}),
    "pallas": dict(t5_overrides={"attention_impl": "pallas",
                                 "decode_attention_impl": "pallas"},
                   clip_overrides={"attention_impl": "pallas"}),
}


def north_star_setup(seed: int = 0, device: Optional[torch.device] = None,
                     *, path: str = "main", params: Optional[MPRGen] = None
                     ) -> Tuple[ServingExperiment, List[dict],
                                Dict[str, np.ndarray]]:
    """The JAX ``bench.py`` north-star serving load at full width: t5-small
    + CLIP ViT-B/32 with the attention knobs of ``SERVE_PATHS[path]``, bf16,
    chunk B=512, retrieval k=1 with the quantifier, seeded random weights
    (or ``params``); synthetic SLAKE with 410 corpus images x 3 QA = 1,230
    retrieval entries, 8 validation images and 512 test images x 3 = 1,536
    questions. Returns (experiment, test entries, images by name)."""
    splits, images = synthetic_slake(410, 512, image_size=224, seed=seed,
                                     n_validate=8)
    cfg = synthetic_config(batch_size=512, epochs=1, retrieval=True, k=1,
                           image_size=224)
    cfg.update(seed=seed, compute_dtype="bfloat16",
               **copy.deepcopy(SERVE_PATHS[path]))
    exp = ServingExperiment(cfg, train=splits["train"],
                            validate=splits["validate"], test=splits["test"],
                            images=images, params=params, device=device)
    return exp, splits["test"], images
