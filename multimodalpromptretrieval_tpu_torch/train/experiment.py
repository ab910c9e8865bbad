"""Training experiment: config -> data -> retrieval hints -> model -> train.

Counterpart of the training half of ``Experiment``
(``multimodalpromptretrieval_tpu/train/experiment.py``) for the generative
ViT variant on one device, behind the same JSON config keys. It is built as
:class:`~multimodalpromptretrieval_tpu_torch.serving.ServingExperiment` is
(model, tokenizers, retrieval index from in-memory splits) and adds what
training needs:

  * retrieval hints per entry, precomputed once per phase (CLIP and the
    corpus are frozen, so they do not change between epochs);
  * the frozen ViT trunk run once per unique image into a device-resident
    vision-token table; batches carry row numbers and gather on the device;
  * fixed-shape batches with a per-epoch shuffle seeded by crc32 of
    (split, seed, epoch), the same order as the JAX package;
  * ``train(resume=)``: the next batch is shipped while the step runs, the
    loss stays on the device until the epoch ends, a non-finite loss raises,
    the best validation loss writes a checkpoint in the JAX npz format,
    ReduceLROnPlateau, early stop after 30 epochs without improvement.

Not ported yet: ``test()`` and its metrics, the CLI, the disk datasets and
the variants other than generative ViT (ROADMAP A7-A10).
"""

from __future__ import annotations

import copy
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.data.batching import (
    Batch,
    encode_unique_chunks,
    make_batches,
)
from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.serving import (
    SERVE_PATHS,
    ServingExperiment,
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt
from multimodalpromptretrieval_tpu_torch.train import step as steps
from multimodalpromptretrieval_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    adamw_init,
)
from multimodalpromptretrieval_tpu_torch.train.rng import dropout_generator
from multimodalpromptretrieval_tpu_torch.utils import get_model_prefix


class TrainingExperiment(ServingExperiment):
    """``ServingExperiment`` plus the optimizer, the steps and the train
    loop. ``device=None`` is the card. Splits are lists of entries in the
    parsed dataset schema; ``self.splits[name]`` holds them."""

    def __init__(self, cfg: Dict[str, Any], *, train: Sequence[dict],
                 validate: Sequence[dict] = (), test: Sequence[dict] = (),
                 images, params: Optional[mprgen.MPRGen] = None,
                 device: Optional[torch.device] = None,
                 train_mode: bool = True, model_file: Optional[str] = None,
                 log_root: str = "logs", model_root: str = "models",
                 quiet: bool = False):
        super().__init__(cfg, train=train, validate=validate, test=test,
                         images=images, params=params, device=device,
                         train_mode=train_mode)
        if not self.model_cfg.use_image_info:
            raise NotImplementedError(
                "only the image-prefix generative variant trains "
                "(ROADMAP A9)")
        self.quiet = quiet
        self.log_root = log_root
        self.model_root = model_root
        self.model_prefix = (os.path.splitext(model_file)[0] if model_file
                             else get_model_prefix(cfg))
        self.model_path = (model_file if model_file else os.path.join(
            model_root, self.model_prefix + ".npz"))
        seed = cfg.get("seed", 88)
        self.dropout_gen = dropout_generator(seed, self.device)
        self.trainable = mprgen.trainable_mask(self.params, self.model_cfg)
        self._moments_dtype = cfg.get("adamw_moments_dtype")
        self.opt_state = (adamw_init(self.params, self._moments_dtype)
                          if train_mode else None)
        self._hints: Dict[str, Dict[str, str]] = {}
        self._qemb_cache: Dict[tuple, tuple] = {}
        self._token_cache: Dict[str, Dict[tuple, List[int]]] = {}
        # (device table (U, P, C), image name -> row)
        self._vision_tokens = None
        self._compute = steps.ComputeCopy()
        self._train_step = None
        self._eval_step = None
        self._predict_step = None

    # -- retrieval hints ----------------------------------------------------

    def _query_embeddings(self, split_name: str) -> torch.Tensor:
        """CLIP image (+) text embeddings of every entry of a split, on
        the device; memoized per (split, params) pair."""
        entries = self.splits[split_name]
        key = (split_name, id(self.params))
        hit = self._qemb_cache.get(key)
        if hit is not None and hit[0] == len(entries):
            return hit[1]
        ids_all = self.clip_tokenizer.tokenize(
            [e["question"] for e in entries])
        out = encode_unique_chunks(
            list(range(len(entries))),
            lambda i: (self.images[entries[i]["image_name"]], ids_all[i]),
            lambda x: x, lambda x: self._clip_embed(*x), self.batch_size)
        result = out[0].float()
        self._qemb_cache[key] = (len(entries), result)
        return result

    def precompute_hints(self, split_name: str) -> None:
        """The retrieval prompt string of each entry of a split."""
        if self.retrieval_index is None:
            return
        prompts = self.retrieval_index.retrieve(
            self._query_embeddings(split_name),
            use_quantifier=self.use_quantifier, k=self.k)
        table = self._hints.setdefault(split_name, {})
        for e, p in zip(self.splits[split_name], prompts):
            table[e["question_id"]] = p
        # hints changed -> cached token ids of this split are stale
        self._token_cache.pop(split_name, None)

    def hint_for(self, entry: dict, split_name: str) -> str:
        if self.retrieval_index is None:
            return ""
        return self._hints.get(split_name, {}).get(entry["question_id"], "")

    # -- batching -----------------------------------------------------------

    def encode_entry(self, entry: dict, split_name: str) -> List[int]:
        """Task prefix + question + retrieved hint (appended with no
        separator), tokenized; cached per (question_id, task) across
        epochs."""
        cache = self._token_cache.setdefault(split_name, {})
        key = (entry["question_id"], entry["task"])
        ids = cache.get(key)
        if ids is None:
            text = (f"Answer the {entry['task']} question: "
                    + entry["question"] + self.hint_for(entry, split_name))
            ids = self.tokenizer.encode(
                text, max_length=self.model_cfg.max_source_length)
            cache[key] = ids
        return ids

    def build_vision_token_cache(self, *split_names: str) -> bool:
        """Run the FROZEN vision trunk once per unique image of the named
        splits and keep the (U, P, C) token table on the device: the tower
        forward leaves the train step, and a batch carries row numbers
        instead of raw images. The trainable tail (the t5-large projection)
        still runs in the step. Returns False, leaving the image path in
        place, when ``cache_vision_tokens`` is 0 in the config or the table
        would exceed ``vision_cache_max_bytes`` (default 4 GiB)."""
        if not self.cfg.get("cache_vision_tokens", True):
            return False
        names = list(dict.fromkeys(
            e["image_name"] for s in split_names for e in self.splits[s]))
        if not names:
            return False
        step = steps.make_vision_tokens_step(self.model_cfg, self._compute)
        cap = int(self.cfg.get("vision_cache_max_bytes", 4 << 30))
        # upload in the compute dtype (the step casts on the device anyway)
        dt = mprgen.compute_dtype(self.model_cfg)
        out = encode_unique_chunks(
            names, lambda n: self.images[n],
            lambda x: torch.from_numpy(x).to(dt).to(self.device),
            lambda x: step(self.params, x), self.batch_size,
            first_chunk_guard=lambda rows: len(names) * rows[0].numel()
            * rows.element_size() > cap)
        if out is None:
            return False
        self._vision_tokens = (out[0], {n: i for i, n in enumerate(names)})
        return True

    def make_split_batches(self, split_name: str, shuffle: bool = False,
                           epoch: int = 0) -> List[Batch]:
        """Fixed-shape batches of a split. zlib.crc32, not hash(): string
        hashing is salted per process. ``epoch`` folds into the seed so
        that each epoch draws a fresh, process-stable permutation."""
        entries = self.splits[split_name]
        seed = zlib.crc32(
            f"{split_name}:{int(self.cfg.get('seed', 88))}:{epoch}".encode())
        rng = np.random.default_rng(seed) if shuffle else None
        vt = self._vision_tokens
        use_vt = vt is not None and all(e["image_name"] in vt[1]
                                        for e in entries)
        return make_batches(
            entries, self.batch_size,
            encode_fn=lambda e: self.encode_entry(e, split_name),
            array_fns={"vision_rows": lambda es: np.asarray(
                [vt[1][e["image_name"]] for e in es], np.int32)}
            if use_vt else None,
            image_fn=None if use_vt else (lambda es: np.stack(
                [self.images[e["image_name"]] for e in es])),
            target_fn=lambda e: self.tokenizer.encode(
                e["answer"], max_length=self.model_cfg.max_target_length),
            shuffle_rng=rng,
            max_source_length=self.model_cfg.max_source_length)

    def device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device (queued, not waited for);
        ``vision_rows`` becomes ``vision_tokens`` by a device-side gather
        from the token table."""
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.arrays.items()}
        rows = out.pop("vision_rows", None)
        if rows is not None:
            out["vision_tokens"] = self._vision_tokens[0][rows.long()]
        return out

    # -- steps --------------------------------------------------------------

    def train_step(self):
        if self._train_step is None:
            self._train_step = steps.make_train_step(
                self.model_cfg, self.trainable, self._compute)
        return self._train_step

    def eval_step(self):
        if self._eval_step is None:
            self._eval_step = steps.make_eval_loss_step(self.model_cfg,
                                                        self._compute)
        return self._eval_step

    def predict_step(self):
        if self._predict_step is None:
            self._predict_step = steps.make_predict_step(
                self.model_cfg, compute=self._compute)
        return self._predict_step

    # -- phases -------------------------------------------------------------

    def validation_loss(self, batches: List[Batch]) -> float:
        """Mean of the per-batch means weighted by the true batch sizes."""
        step = self.eval_step()
        total, n = 0.0, 0
        for b in batches:
            loss = float(step(self.params, self.device_batch(b)))
            total += loss * len(b)
            n += len(b)
        return total / max(n, 1)

    def log(self, msg: str) -> None:
        if not self.quiet:
            print(msg)

    def train(self, resume: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        hp = cfg["hyperparameters"]
        if self.opt_state is None:  # experiment built with train_mode=False
            self.opt_state = adamw_init(self.params, self._moments_dtype)
        resume_meta: Dict[str, Any] = {}
        if resume:
            if not os.path.exists(self.model_path):
                raise FileNotFoundError(
                    f"resume: no checkpoint at {self.model_path}")
            self.params, opt, resume_meta = ckpt.load_checkpoint(
                self.model_path, self.model_cfg, self.opt_state, self.device)
            if opt is not None:
                self.opt_state = opt
            # new modules: the steps' compute copy and flags start over
            self._compute = steps.ComputeCopy()
            self._train_step = self._eval_step = self._predict_step = None
            if cfg.get("further_finetune"):
                # the reference's new save path and LR reset
                self.model_path = os.path.join(
                    self.model_root,
                    self.model_prefix + "_msrc_with_retrieval_80.npz")
        scheduler = ReduceLROnPlateau(lr=hp["learning_rate"])
        if resume and not cfg.get("further_finetune"):
            # a resumed run continues at the decayed LR; patience counters
            # are fresh either way
            scheduler.lr = float(resume_meta.get("lr", scheduler.lr))
        self.scheduler = scheduler
        if self.retrieval_index is not None:
            self.retrieval_index.is_training_phase = True
            self.precompute_hints("train")
            self.precompute_hints("validate")

        self.build_vision_token_cache("train", "validate")
        step = self.train_step()
        val_batches = self.make_split_batches("validate")
        # best_valid resets to inf even on resume (the reference's quirk):
        # the first resumed epoch always re-saves the checkpoint
        best_valid = float("inf")
        best_epoch = 0
        streak = 0
        parameter_updates = 0
        train_losses: List = []
        valid_losses: List = []
        train_info_path = os.path.join(self.log_root, self.model_prefix)
        os.makedirs(train_info_path, exist_ok=True)

        for epoch in range(hp["epochs"]):
            self.log(f"Starting epoch {epoch} ...")
            self.log(f"The learning rate is now {scheduler.lr}")
            batches = self.make_split_batches("train", shuffle=True,
                                              epoch=epoch)
            t0 = time.time()
            epoch_losses = []
            # prefetch: ship batch i + 1 while step i runs
            nxt = self.device_batch(batches[0]) if batches else None
            for i, b in enumerate(batches):
                db = nxt
                if i + 1 < len(batches):
                    nxt = self.device_batch(batches[i + 1])
                loss = step(self.params, self.opt_state, db, scheduler.lr,
                            self.dropout_gen)
                parameter_updates += 1
                # the loss stays on the device: a float() here would sync
                # the host every step
                epoch_losses.append(loss * len(b))
            train_total = (float(torch.stack(epoch_losses).sum())
                           if epoch_losses else 0.0)
            if not np.isfinite(train_total):
                # a non-finite loss poisons the AdamW moments: stop; the
                # best checkpoint on disk is the recovery point
                raise FloatingPointError(
                    f"non-finite training loss at update "
                    f"{parameter_updates}; resume from {self.model_path}")
            n_train = sum(len(b) for b in batches)
            self.log(f"Train loss is {train_total / max(n_train, 1)} "
                     f"({time.time() - t0:.1f}s)")
            valid_loss = self.validation_loss(val_batches)
            scheduler.step(valid_loss)
            self.log(f"Validation Loss: {valid_loss} | Best Validation "
                     f"Loss: {best_valid} at epoch {best_epoch}")
            if valid_loss < best_valid:
                self.log(f"Saving model to {self.model_path} ...")
                # checkpoint_save_optimizer=0 drops the AdamW moments from
                # the file; a resume then restarts with fresh moments
                ckpt.save_checkpoint(
                    self.model_path, self.params, self.model_cfg,
                    self.opt_state if cfg.get(
                        "checkpoint_save_optimizer", True) else None,
                    metadata={"epoch": epoch, "valid_loss": valid_loss,
                              "lr": scheduler.lr, "config": cfg})
                best_valid = valid_loss
                best_epoch = epoch
                streak = 0
            else:
                streak += 1
            train_losses.append(
                (parameter_updates, train_total / max(n_train, 1)))
            valid_losses.append((parameter_updates, valid_loss))
            if streak > 30:
                self.log(f"Loss didn't improve for {streak - 1} epochs. "
                         "Stopping training ...")
                break

        for name, rows in (("training_loss.txt", train_losses),
                           ("validation_loss.txt", valid_losses)):
            with open(os.path.join(train_info_path, name), "w") as f:
                f.write("parameter_updates,loss\n")
                for u, loss in rows:
                    f.write(f"{u},{loss}\n")
        return {"best_valid_loss": best_valid, "best_epoch": best_epoch,
                "parameter_updates": parameter_updates,
                "train_losses": train_losses, "valid_losses": valid_losses}


def north_star_train_setup(seed: int = 0,
                           device: Optional[torch.device] = None, *,
                           params: Optional[mprgen.MPRGen] = None,
                           **kw) -> TrainingExperiment:
    """The JAX ``bench.py`` train stage at full width: t5-small + CLIP
    ViT-B/32, ``attention_impl="row"`` in both towers and the encoder, fp32
    masters with bf16 compute, B=128, dropout 0.1, retrieval k=1 with the
    quantifier, seeded random weights (or ``params``); synthetic SLAKE with
    410 corpus images x 3 QA = 1,230 training entries (prompts of at most 32
    tokens behind the 50-token prefix, answers of at most 8) and 8
    validation images. ``kw`` goes to :class:`TrainingExperiment`."""
    splits, images = synthetic_slake(410, 0, image_size=224, seed=seed,
                                     n_validate=8)
    cfg = synthetic_config(batch_size=128, epochs=1, retrieval=True, k=1,
                           image_size=224)
    cfg.update(seed=seed, compute_dtype="bfloat16",
               **copy.deepcopy(SERVE_PATHS["main"]))
    cfg["hyperparameters"]["learning_rate"] = 1e-4
    return TrainingExperiment(cfg, train=splits["train"],
                              validate=splits["validate"], images=images,
                              params=params, device=device, **kw)
