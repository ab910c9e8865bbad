"""Config -> model, tokenizers and retrieval index, for serving.

The serving half of ``Experiment`` (``multimodalpromptretrieval_tpu/
train/experiment.py``), read from the same JSON config keys: ``dataset``,
``datafolder``, ``transfer_dataset``, ``fewshot_training_tasks``,
``train_subset``, ``max_answers``, ``T5_version``, ``t5_overrides``,
``clip_overrides``, ``compute_dtype``, ``retrieval``, ``retrieval_dataset``,
``retrieval_subset``, ``cache_retrieval``, ``retrieval_cache_dir``,
``retrieval_cache_compat``, ``use_additional_retrieval_data`` /
``additional_retrieval_cache``, ``k``, ``quantifier``,
``hyperparameters.batch_size``, ``max_source_length``, ``seed``,
``spiece_model`` / ``clip_bpe``, the variant keys ``use_image_info``,
``use_prediction_head``, ``use_BAN``, ``max_answers`` (the head's class
count), ``vision_encoder`` (``RN50`` / ``RN50x4``: the ResNet tower, with
``resnet_overrides``) and the pretrained weights ``t5_checkpoint``,
``clip_checkpoint``, ``vision_checkpoint``, ``reference_checkpoint`` and
``mapping_checkpoint`` (:meth:`ServingExperiment._load_pretrained`),
``generator`` (``"lm"``: the decoder-only MoE LM of ``models/moe_lm.py``
in T5's place, its ``config.json`` keys under ``lm_overrides`` over
Kimi-VL-A3B's, its weights held in ``compute_dtype``; no checkpoint keys,
no ``parallelism``), and
``parallelism`` (``parallel/mesh.build_mesh``, checked first: the mesh of
the process group, over whose "data" axis ``serve.MPRServer`` splits each
chunk's rows).

Data comes from disk (the dataset parsers of ``data/datasets.py`` and the
image cache of ``data/images.py``) or in memory: QA entries in the parsers'
dict schema and preprocessed images (3, R, R) keyed by image name.
:func:`synthetic_slake` builds such data from a seed with numpy alone,
:func:`synthetic_config` a tiny config for it, and :func:`north_star_setup`
and :func:`north_star_t5_large_setup` the full-width serving loads that
``chip_smoke.py`` drives.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import random
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch import bridge
from multimodalpromptretrieval_tpu_torch.data import roco_questions, synthetic
from multimodalpromptretrieval_tpu_torch.data.datasets import (
    VQADataset,
    create_ans2label,
    load_dataset,
)
from multimodalpromptretrieval_tpu_torch.data.images import ImageCache
from multimodalpromptretrieval_tpu_torch.models.clip import (
    IMAGE_MEAN,
    IMAGE_STD,
    CLIPConfig,
    clip_encode_image,
    clip_encode_text,
    truncate_text_ids,
)
from multimodalpromptretrieval_tpu_torch.models import convert, moe_lm
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    MPRGen,
    MPRGenConfig,
    init_mprgen,
)
from multimodalpromptretrieval_tpu_torch.models.resnet import (
    ResNetConfig,
    resnet_from_openai,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
from multimodalpromptretrieval_tpu_torch.parallel import multihost
from multimodalpromptretrieval_tpu_torch.retrieval.index import RetrievalIndex
from multimodalpromptretrieval_tpu_torch.text import (
    CLIPBPETokenizer,
    T5SentencePieceTokenizer,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt
from multimodalpromptretrieval_tpu_torch.utils import get_model_prefix

# where use_additional_retrieval_data finds the prebuilt ROCO index when
# the config names no additional_retrieval_cache (the JAX package's path)
ROCO_CACHE = os.path.join("synthetic_data", "cache", "ROCOFeatureDataset",
                          "index.npz")


def resolve_device(device) -> torch.device:
    """The device of an entry point: ``None`` means the card (in a process
    group, this process's: ``multihost.local_device_index``), and raises
    when there is none; the CPU is used only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card unless "
            "called with device=\"cpu\"")
    if multihost.process_count() > 1:
        return torch.device("cuda", multihost.local_device_index())
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


def load_filtered_triple(cfg: Dict[str, Any], folder: str, data_name: str):
    """(train, validate, test) datasets of ``data_name`` with the config's
    filters applied in the reference's order (main.py:74-86): the fewshot
    task filter, ``train_subset`` stratified subsampling, then
    ``max_answers`` across the three splits."""
    dataset_train = load_dataset(folder, data_name, "train")
    fewshot = cfg.get("fewshot_training_tasks") or {}
    if fewshot.get("enabled"):
        dataset_train.filter(
            fewshot.get("tasks", []),
            fewshot.get("examples_per_task", float("inf")))
    if "train_subset" in cfg:
        split = dataset_train.get_stratified_split(
            split_fraction=cfg["train_subset"])
        dataset_train.entries = [dataset_train.entries[x] for x in split]
    dataset_validate = load_dataset(folder, data_name, "validate")
    dataset_test = load_dataset(folder, data_name, "test")
    if cfg.get("max_answers"):
        answer_set = dataset_train.filter_max_answers(cfg["max_answers"])
        dataset_validate.filter_max_answers(cfg["max_answers"],
                                            set(answer_set))
        dataset_test.filter_max_answers(cfg["max_answers"], set(answer_set))
    return dataset_train, dataset_validate, dataset_test


class ServingExperiment:
    """What :class:`~multimodalpromptretrieval_tpu_torch.serve.MPRServer`
    needs: ``model_cfg``, ``params`` (fp32 master :class:`MPRGen`),
    ``tokenizer``, ``clip_tokenizer``, ``retrieval_index``, ``batch_size``,
    ``k``, ``use_quantifier`` and ``model_path``.

    Data: with ``train`` given, the in-memory splits and ``images`` (name ->
    (3, R, R) array); with ``train=None``, the config's ``dataset`` under
    ``datafolder``, read and filtered as the JAX ``Experiment`` does, its
    images through the ``images_{split}_{size}.npz`` caches. ``datasets``
    holds the three splits, ``splits`` their entries.

    ``params``: given (e.g. ``bridge.params_from_jax``), or, when None, a
    seeded random init from the config's ``seed`` on the host, filled from
    the pretrained checkpoints the config names, then moved to the device
    once. ``device=None`` is the
    card (:func:`resolve_device`). ``train_mode`` builds the retrieval
    index in its training phase (the nearest neighbour, the query itself,
    is dropped). The checkpoint is ``model_file`` or
    ``{model_root}/{model prefix}.npz``; a server loads it when it exists.
    :class:`~multimodalpromptretrieval_tpu_torch.train.experiment.
    TrainingExperiment` builds on this class.
    """

    def __init__(self, cfg: Dict[str, Any], *,
                 train: Optional[Sequence[dict]] = None,
                 validate: Sequence[dict] = (), test: Sequence[dict] = (),
                 images: Optional[Mapping[str, np.ndarray]] = None,
                 params: Optional[MPRGen] = None,
                 device: Optional[torch.device] = None,
                 train_mode: bool = False, model_file: Optional[str] = None,
                 model_root: str = "models"):
        self.cfg = cfg
        # the parallelism key is honoured or refused before any work
        self.mesh = pmesh.build_mesh(cfg)
        self.device = resolve_device(device)
        self.model_root = model_root
        self.model_prefix = (os.path.splitext(model_file)[0] if model_file
                             else get_model_prefix(cfg))
        self.model_path = (model_file if model_file else os.path.join(
            model_root, self.model_prefix + ".npz"))

        clip_cfg = CLIPConfig.vit_b32()
        if cfg.get("clip_overrides"):
            clip_cfg = dataclasses.replace(clip_cfg, **cfg["clip_overrides"])
        self.image_size = clip_cfg.image_resolution
        if train is None:
            corpus = self._load_disk(train_mode)
        else:
            self.data_name = cfg.get("dataset")
            self.datasets = {name: VQADataset.from_entries(name, list(es))
                             for name, es in (("train", train),
                                              ("validate", validate),
                                              ("test", test))}
            self.images = images
            corpus = tokenizer_corpus(train, validate, test)
        self.label2ans, self.ans2label = create_ans2label(
            *self.datasets.values())
        for ds in self.datasets.values():
            ds.add_labels(self.ans2label)

        spiece = cfg.get("spiece_model")
        if spiece and os.path.exists(spiece):
            self.tokenizer = T5SentencePieceTokenizer.from_spiece_model(
                spiece)
        else:
            self.tokenizer = T5SentencePieceTokenizer.from_corpus(corpus)
        # the reference adds one "[itk]" token (T5VisionModel.py:58-61)
        self.tokenizer.add_tokens(["[itk]"])

        t5_cfg = T5Config.from_version(cfg.get("T5_version", "t5-small"))
        if cfg.get("t5_overrides"):
            t5_cfg = dataclasses.replace(t5_cfg, **cfg["t5_overrides"])
        lm_cfg = self._lm_config()
        if lm_cfg is not None and len(self.tokenizer) > lm_cfg.vocab_size:
            raise ValueError(
                f"tokenizer has {len(self.tokenizer)} ids but the LM "
                f"embedding has only {lm_cfg.vocab_size} rows")
        if lm_cfg is None and len(self.tokenizer) > t5_cfg.vocab_size:
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
        # BAN's head always spans every answer (the JAX Experiment's rule)
        num_classes = (cfg["max_answers"]
                       if cfg.get("max_answers") and not cfg.get("use_BAN")
                       else len(self.ans2label))
        self.model_cfg = MPRGenConfig(
            t5=t5_cfg, clip=clip_cfg, resnet=self._resnet_config(clip_cfg),
            use_image_info=bool(cfg["use_image_info"]),
            use_prediction_head=bool(cfg.get("use_prediction_head")),
            use_ban=bool(cfg.get("use_BAN")),
            num_classes=num_classes,
            freeze=bool(cfg.get("freeze")),
            max_source_length=cfg.get("max_source_length", 512),
            max_target_length=cfg.get("max_target_length", 128),
            use_mapping=bool(cfg.get("mapping_checkpoint")),
            compute_dtype=cfg.get("compute_dtype", "float32"), lm=lm_cfg)
        # the checkpoint files the weights were filled from
        self.loaded_files: List[str] = []
        seeded = params is None
        if seeded and lm_cfg is not None:
            params = init_mprgen(self.model_cfg, cfg.get("seed", 88))
            moe_lm.hold_in(params.lm, getattr(
                torch, self.model_cfg.compute_dtype))
        elif seeded:
            params = self._load_pretrained(
                init_mprgen(self.model_cfg, cfg.get("seed", 88)))
        self.params = params.to(self.device)

        self.batch_size = cfg["hyperparameters"]["batch_size"]
        self.k = cfg.get("k", 15)
        self.use_quantifier = not ("quantifier" in cfg
                                   and not cfg["quantifier"])
        self.retrieval_index: Optional[RetrievalIndex] = None
        self.retrieval_dataset: Optional[VQADataset] = None
        if cfg.get("retrieval"):
            # an index embedded by other weights than the seed's is never
            # written to or read from the cache (the key names a checkpoint
            # by its path, not by what the file holds)
            self._setup_retrieval(train_mode, cacheable=(
                train is None and seeded and not self.loaded_files))

    def _lm_config(self) -> Optional[moe_lm.LMConfig]:
        """The LM generator's config (``generator: "lm"``), or None for
        T5; the options the LM does not take raise ``ValueError``."""
        cfg = self.cfg
        generator = cfg.get("generator", "t5")
        if generator not in ("t5", "lm"):
            raise ValueError(f"unknown generator {generator!r}")
        if generator == "t5":
            return None
        mesh = self.mesh
        options = {"tp": mesh.n_model if mesh.n_model > 1 else 0,
                   "sharded_server": mesh.n_data if mesh.n_data > 1 else 0,
                   "pipe": mesh.n_pipe if mesh.n_pipe > 1 else 0,
                   "seq": mesh.n_seq if mesh.n_seq > 1 else 0}
        options.update({key: cfg.get(key) for key in (
            "t5_checkpoint", "clip_checkpoint", "vision_checkpoint",
            "reference_checkpoint", "mapping_checkpoint",
            "use_prediction_head", "use_BAN")})
        if "RN" in (cfg.get("vision_encoder") or ""):
            options["vision_encoder"] = cfg["vision_encoder"]
        moe_lm.refuse_options(**options)
        return moe_lm.LMConfig.from_dict(cfg.get("lm_overrides") or {})

    def _resnet_config(self, clip_cfg: CLIPConfig) -> Optional[ResNetConfig]:
        """``vision_encoder`` RN50x4 (a name with "x4") or RN50, at the CLIP
        config's resolution (the images are preprocessed once, for the
        ViT, and the convolutional tower takes them at that size), then
        ``resnet_overrides``; None for the ViT."""
        if "RN" not in (self.cfg.get("vision_encoder") or ""):
            return None
        rn = (ResNetConfig.rn50x4() if "x4" in self.cfg["vision_encoder"]
              else ResNetConfig.rn50())
        rn = dataclasses.replace(rn, image_resolution=clip_cfg.image_resolution)
        return dataclasses.replace(rn, **{
            k: tuple(v) if k == "layers" else v
            for k, v in (self.cfg.get("resnet_overrides") or {}).items()})

    def _load_pretrained(self, model: MPRGen) -> MPRGen:
        """The seeded init (on the host) with the parts the config's
        checkpoint files hold; a key whose file does not exist is skipped,
        as in the JAX package:

          * ``reference_checkpoint``: a whole reference model (every part
            the file holds; nothing else is read);
          * ``mapping_checkpoint``: the mapping MLP (an npz of either
            package; the key also turns ``use_mapping`` on, so that a
            missing file leaves the seeded mapping in place);
          * ``t5_checkpoint``: HF T5, resized to the tokenizer's length;
          * ``vision_checkpoint``, else ``clip_checkpoint``: OpenAI-layout
            CLIP (PubMedCLIP's ``visual_encoder.`` prefix stripped), into
            the ResNet when it is a ModifiedResNet, else into the ViT.

        torch files are read on the host (``{"model_state_dict": ...}`` and
        ``{"state_dict": ...}`` unwrapped; tensors only, no arbitrary
        objects). The T5 config's ``vocab_size`` follows the loaded
        embedding's rows. The paths read go to ``loaded_files``."""
        cfg, mcfg = self.cfg, self.model_cfg

        def present(key):
            return bool(cfg.get(key)) and os.path.exists(cfg[key])

        vision = cfg.get("vision_checkpoint") or cfg.get("clip_checkpoint")
        if not (any(present(k) for k in ("reference_checkpoint",
                                          "mapping_checkpoint",
                                          "t5_checkpoint"))
                or (vision and os.path.exists(vision))):
            return model
        tree = bridge.tree_numpy(bridge.params_to_jax(model, mcfg))

        def read(path):
            self.loaded_files.append(path)
            return _load_torch(path)

        if present("reference_checkpoint"):
            tree.update(convert.mprgen_from_reference_checkpoint(
                read(cfg["reference_checkpoint"]), mcfg))
        else:
            if present("mapping_checkpoint"):
                self.loaded_files.append(cfg["mapping_checkpoint"])
                tree["mapping"] = ckpt.load_mapping_tree(
                    cfg["mapping_checkpoint"])
            if present("t5_checkpoint"):
                tree["t5"] = convert.resize_token_embeddings(
                    convert.t5_from_hf(read(cfg["t5_checkpoint"]),
                                       mcfg.t5), len(self.tokenizer))
            if vision and os.path.exists(vision):
                sd = {k[len("visual_encoder."):]
                      if k.startswith("visual_encoder.") else k: v
                      for k, v in read(vision).items()}
                if "visual.layer1.0.conv1.weight" in sd:
                    if mcfg.resnet is None:
                        raise ValueError(
                            f"{vision} holds a ModifiedResNet, but the "
                            "config's vision_encoder is not an RN model")
                    tree["clip_rn"] = resnet_from_openai(sd, mcfg.resnet)
                else:
                    tree["clip"] = convert.clip_from_openai(sd, mcfg.clip)
        rows = tree["t5"]["shared"].shape[0]
        if len(self.tokenizer) > rows:
            raise ValueError(
                f"tokenizer has {len(self.tokenizer)} ids but the loaded T5 "
                f"embedding has only {rows} rows")
        self.model_cfg = dataclasses.replace(
            mcfg, t5=dataclasses.replace(mcfg.t5, vocab_size=rows))
        return bridge.params_from_jax(tree, self.model_cfg)

    @property
    def splits(self) -> Dict[str, List[dict]]:
        """The entries of each split (a split's current list: the
        reference's ``retrieval_subset`` shrinks the training split)."""
        return {name: ds.entries for name, ds in self.datasets.items()}

    def _load_disk(self, train_mode: bool) -> List[str]:
        """The three splits and their image caches from ``datafolder``;
        returns the tokenizer corpus."""
        cfg = self.cfg
        data_name = cfg["dataset"]
        # transfer evaluation swaps the dataset when not training
        if "transfer_dataset" in cfg and not train_mode:
            data_name = cfg["transfer_dataset"]
        self.data_name = data_name
        folder = cfg["datafolder"]
        triple = load_filtered_triple(cfg, folder, data_name)
        self.datasets = dict(zip(("train", "validate", "test"), triple))
        if data_name != cfg["dataset"]:
            # transfer evaluation: the tokenizer is the one the checkpoint
            # was trained with, so the corpus is the SOURCE dataset's
            state = random.getstate()  # get_stratified_split reseeds
            try:
                source = load_filtered_triple(cfg, folder, cfg["dataset"])
            finally:
                random.setstate(state)
        else:
            source = triple
        self.images = ImageCache({})
        for split, ds in self.datasets.items():
            self.images.update(self._image_cache(ds.entries, split))
        return tokenizer_corpus(*(ds.entries for ds in source))

    def _image_cache(self, entries: Sequence[dict],
                     split: str) -> ImageCache:
        """The preprocessed images of ``entries``, from the cache file of
        each dataset root (built on the device where missing)."""
        roots: Dict[str, List[dict]] = {}
        for e in entries:
            roots.setdefault(e["dataroot"], []).append(e)
        cache = ImageCache({})
        for root, es in roots.items():
            cache.update(ImageCache.build(root, es, split,
                                          size=self.image_size,
                                          device=self.device))
        return cache

    def _setup_retrieval(self, train_mode: bool, cacheable: bool) -> None:
        """The retrieval corpus (``retrieval_dataset`` or the training
        split, cut by ``retrieval_subset``) embedded into the index, through
        the content-keyed cache when ``cache_retrieval`` (default on)."""
        cfg = self.cfg
        if "retrieval_dataset" in cfg:
            rds = load_dataset(cfg["datafolder"], cfg["retrieval_dataset"],
                               "train")
            images = self._image_cache(rds.entries, "train")
        else:
            # reference-exact (main.py:107-110): retrieval_subset mutates
            # THE SHARED training split, which shrinks too
            rds, images = self.datasets["train"], self.images
        if "retrieval_subset" in cfg:
            split = rds.get_stratified_split(
                split_fraction=cfg["retrieval_subset"])
            rds.entries = [rds.entries[x] for x in split]
        self.retrieval_dataset = rds
        cache_path = None
        if cacheable and cfg.get("cache_retrieval", True):
            cache_path = os.path.join(cfg.get("retrieval_cache_dir", "cache"),
                                      self._retrieval_cache_key(rds),
                                      "index.npz")
        self.retrieval_index = RetrievalIndex.build(
            self._clip_embed, rds.entries,
            lambda names: np.stack([images[n] for n in names]),
            self.clip_tokenizer.tokenize, batch_size=self.batch_size,
            is_training_phase=train_mode, retrieval_k=self.k,
            cache_path=cache_path, device=self.device)
        if cfg.get("use_additional_retrieval_data"):
            # the prebuilt ROCO corpus, appended when its file exists (as
            # the JAX Experiment does; synthetic_roco / build_roco_index)
            extra = cfg.get("additional_retrieval_cache", ROCO_CACHE)
            if os.path.exists(extra):
                self.retrieval_index.extend(
                    RetrievalIndex.load(extra, device=self.device))

    def _retrieval_cache_key(self, rds: VQADataset) -> str:
        """The reference keys by class name only (quirk #4, stale across
        subsets and encoders; ``retrieval_cache_compat``). The default key
        hashes the corpus and what its embeddings depend on: the JAX
        package's content key plus the package, since the two draw
        different weights from one seed."""
        name = type(rds).__name__
        if self.cfg.get("retrieval_cache_compat"):
            return name
        src = json.dumps({
            "class": name,
            "qids": [str(e["question_id"]) for e in rds.entries],
            "images": [e["image_name"] for e in rds.entries],
            "seed": self.cfg.get("seed", 88),
            "vision_encoder": self.cfg.get("vision_encoder"),
            "vision_checkpoint": self.cfg.get("vision_checkpoint"),
            "clip_overrides": self.cfg.get("clip_overrides"),
            "image_size": self.image_size,
            "package": "torch",
        }, sort_keys=True)
        return f"{name}-{zlib.crc32(src.encode()):08x}"

    @torch.inference_mode()
    def _clip_embed(self, images: np.ndarray, text_ids: np.ndarray,
                    clip=None) -> torch.Tensor:
        """CLIP image (+) text embedding with the fp32 master params (or
        ``clip``, a server's int8 towers)."""
        clip = self.params.clip if clip is None else clip
        cfg = self.model_cfg.clip
        imgs = torch.as_tensor(np.asarray(images, np.float32),
                               device=self.device)
        ids = torch.as_tensor(truncate_text_ids(text_ids), device=self.device)
        return torch.cat([clip_encode_image(clip, cfg, imgs),
                          clip_encode_text(clip, cfg, ids)], dim=1)


def _load_torch(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file -> {name: fp32 numpy}, read on the host; a
    ``{"model_state_dict": ...}`` (the reference's training checkpoint) or
    ``{"state_dict": ...}`` (PubMedCLIP) wrapper is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return convert.state_dict_to_numpy(obj)


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


def synthetic_roco(n_images: int, *, image_size: int, seed: int = 0
                   ) -> Tuple[List[dict], Dict[str, np.ndarray]]:
    """A synthetic ROCO corpus in memory: each image gets a modality, a
    plane and an organ keyword of ``data/roco_questions``' banks (a drawn
    image beside them), the generator's default buckets turn the keywords
    into QA rows, and the rows become entries in ``ROCODataset``'s schema
    (question_id = row + 100000). Returns (entries, images by name)."""
    rng = random.Random(seed)
    keywords: Dict[str, List[str]] = {}
    images: Dict[str, np.ndarray] = {}
    for i in range(n_images):
        name = f"ROCO_{i:05d}"
        keywords[name] = [rng.choice(bank).split()[0].lower() for bank in (
            roco_questions.MODALITIES, roco_questions.PLANES,
            roco_questions.ORGANS)]
        # the generator names a row's image by its ROCO id + ".jpg"
        images[name + ".jpg"] = normalize_image(synthetic._draw(
            rng.choice(synthetic._SHAPES),
            synthetic._COLORS[rng.choice(sorted(synthetic._COLORS))],
            rng.randint(1, 3), image_size, rng))
    state = random.getstate()  # the generator's buckets reseed random
    try:
        rows = roco_questions.generate_questions(keywords, "", seed=seed,
                                                 require_images=False)
    finally:
        random.setstate(state)
    entries = [{"image_name": image_id, "question": question.lower(),
                "answer": str(answer).lower(), "task": q_type,
                "question_id": str(i + 100000),
                "question_type": question_type.lower()}
               for i, (q_type, image_id, question, answer, question_type)
               in enumerate(rows)]
    return entries, images


def build_roco_index(exp: ServingExperiment, entries: Sequence[dict],
                     images: Mapping[str, np.ndarray],
                     path: str) -> RetrievalIndex:
    """The ROCO retrieval index: ``entries`` embedded (image (+) question)
    by ``exp``'s CLIP towers and saved at ``path``, where a config with
    ``use_additional_retrieval_data`` and ``additional_retrieval_cache:
    path`` appends it to its own index."""
    return RetrievalIndex.build(
        exp._clip_embed, list(entries),
        lambda names: np.stack([images[n] for n in names]),
        exp.clip_tokenizer.tokenize, batch_size=exp.batch_size,
        cache_path=path, device=exp.device)


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
                     *, path: str = "main", params: Optional[MPRGen] = None,
                     config: Optional[Mapping[str, Any]] = None
                     ) -> Tuple[ServingExperiment, List[dict],
                                Dict[str, np.ndarray]]:
    """The JAX ``bench.py`` north-star serving load at full width: t5-small
    + CLIP ViT-B/32 with the attention knobs of ``SERVE_PATHS[path]``, bf16,
    chunk B=512, retrieval k=1 with the quantifier, seeded random weights
    (or ``params``); synthetic SLAKE with 410 corpus images x 3 QA = 1,230
    retrieval entries, 8 validation images and 512 test images x 3 = 1,536
    questions. ``config``: keys set over the config (a variant's, e.g.
    ``{"use_prediction_head": 1}``). Returns (experiment, test entries,
    images by name)."""
    splits, images = synthetic_slake(410, 512, image_size=224, seed=seed,
                                     n_validate=8)
    cfg = synthetic_config(batch_size=512, epochs=1, retrieval=True, k=1,
                           image_size=224)
    cfg.update(seed=seed, compute_dtype="bfloat16",
               **copy.deepcopy(SERVE_PATHS[path]))
    cfg.update(config or {})
    exp = ServingExperiment(cfg, train=splits["train"],
                            validate=splits["validate"], test=splits["test"],
                            images=images, params=params, device=device)
    return exp, splits["test"], images


def t5_large_load(seed: int = 0) -> Tuple[Dict[str, Any],
                                          Dict[str, List[dict]],
                                          Dict[str, np.ndarray]]:
    """The JAX ``bench.py`` ``t5_large`` stage's serving load (its
    ``_bench_setup`` with ``T5_version="t5-large"`` and ``style="open"``):
    t5-large + CLIP ViT-B/32 at 224 px, row attention in both towers and
    the encoder, bf16, chunk B=128, retrieval k=1 with the quantifier; the
    synthetic SLAKE's open corpus (answers of 2-8 T5 tokens): 410 corpus
    images x 3 QA = 1,230 entries, 8 validation images, 512 test images x 3
    = 1,536 questions. Returns (config, splits, images by name); the
    trainer and the server of that stage build from the same splits, so
    their tokenizers agree."""
    splits, images = synthetic_slake(410, 512, image_size=224, seed=seed,
                                     n_validate=8, answer_style="open")
    cfg = synthetic_config(batch_size=128, epochs=1, retrieval=True, k=1,
                           image_size=224)
    cfg.update(seed=seed, compute_dtype="bfloat16", T5_version="t5-large",
               **copy.deepcopy(SERVE_PATHS["main"]))
    return cfg, splits, images


def north_star_t5_large_setup(seed: int = 0,
                              device: Optional[torch.device] = None, **kw
                              ) -> Tuple[ServingExperiment, List[dict],
                                         Dict[str, np.ndarray]]:
    """The serving experiment of :func:`t5_large_load` on seeded random
    weights; a server that loads ``model_path`` (``kw``: ``model_root=``)
    answers from the trained checkpoint. Returns (experiment, test entries,
    images by name)."""
    cfg, splits, images = t5_large_load(seed)
    exp = ServingExperiment(cfg, train=splits["train"],
                            validate=splits["validate"], test=splits["test"],
                            images=images, device=device, **kw)
    return exp, splits["test"], images
