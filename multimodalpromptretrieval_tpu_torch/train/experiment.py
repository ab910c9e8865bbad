"""Training experiment: config -> data -> retrieval hints -> model ->
train / test.

Counterpart of the training half of ``Experiment``
(``multimodalpromptretrieval_tpu/train/experiment.py``) for every variant
(generative, text-only, prediction head, BAN, the ResNet tower, the mapping
MLP) on one device, behind the same JSON config keys. It is built as
:class:`~multimodalpromptretrieval_tpu_torch.serving.ServingExperiment` is
(data from disk or in memory, model, tokenizers, retrieval index) and adds
what training and evaluation need:

  * retrieval hints per entry, precomputed once per phase (CLIP and the
    corpus are frozen, so they do not change between epochs); BAN's
    prompts never carry one (quirk #9);
  * the frozen vision trunk (the ViT's tokens, or the ResNet's grid) run
    once per unique image into a device-resident vision-token table (for
    the variants that read images); batches carry row numbers and gather on
    the device;
  * fixed-shape batches with a per-epoch shuffle seeded by crc32 of
    (split, seed, epoch), the same order as the JAX package;
  * ``train(resume=)``: the next batch is shipped while the step runs, the
    loss stays on the device until the epoch ends, a non-finite loss raises,
    the best validation loss writes a checkpoint in the JAX npz format,
    ReduceLROnPlateau, early stop after 30 epochs without improvement,
    and the train accuracy of the head variants;
  * ``test()``: the checkpoint loaded, the answers over the test split
    (greedy from a device-resident prefix table for the generative
    variant, the predict step on the batches for the others; class ids
    scored as classes), the reference's metrics (``train/metrics.py``) and
    its artifact files;
  * parallelism over the process group from the ``parallelism`` key
    (``parallel/mesh.py``): data parallelism runs each data index's rows
    of the batch; "model" above 1 Megatron tensor parallelism and "pipe"
    above 1 GPipe pipeline parallelism (``parallel/pipeline.py``; both
    together: TP inside each stage), the parameters and AdamW moments in
    each rank's layout; "seq" above 1 ring-attention sequence parallelism
    of the encoder (``parallel/sequence.py``; the generative loss only,
    the parameters replicated). ``test()`` runs un-pipelined (from a dense
    copy after a pipelined train), tensor-parallel over "model", the seq
    ranks replicated. The set-up
    (hints, the vision-token table, the index) stays replicated, and only
    the primary process writes the checkpoint (in the one-process layout,
    gathered from the shards), the loss logs and the test artifacts;
  * :func:`run_from_config`, what ``cli.py`` calls.
"""

from __future__ import annotations

import copy
import json
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
from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    generative_predict_from_prefix,
)
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
from multimodalpromptretrieval_tpu_torch.parallel import multihost
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: F401
    SERVE_PATHS,
    ServingExperiment,
    load_filtered_triple,
    synthetic_config,
    synthetic_slake,
    t5_large_load,
    tokenizer_corpus,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt
from multimodalpromptretrieval_tpu_torch.train import step as steps
from multimodalpromptretrieval_tpu_torch.train.metrics import TestMetrics
from multimodalpromptretrieval_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    adamw_init,
)
from multimodalpromptretrieval_tpu_torch.train.rng import dropout_generator


class TrainingExperiment(ServingExperiment):
    """``ServingExperiment`` plus the optimizer, the steps, the train loop
    and ``test()``. ``device=None`` is the card. Data, as for
    ``ServingExperiment``: in-memory splits (``train=``, ``images=``) or,
    without them, the config's dataset on disk; ``self.splits[name]``
    holds a split's entries."""

    def __init__(self, cfg: Dict[str, Any], *,
                 train: Optional[Sequence[dict]] = None,
                 validate: Sequence[dict] = (), test: Sequence[dict] = (),
                 images=None, params: Optional[mprgen.MPRGen] = None,
                 device: Optional[torch.device] = None,
                 train_mode: bool = True, model_file: Optional[str] = None,
                 log_root: str = "logs", model_root: str = "models",
                 quiet: bool = False):
        super().__init__(cfg, train=train, validate=validate, test=test,
                         images=images, params=params, device=device,
                         train_mode=train_mode, model_file=model_file,
                         model_root=model_root)
        self.quiet = quiet
        self.log_root = log_root
        # the mesh of the steps; None runs one process's
        self._par = self.mesh if self.mesh.world > 1 else None
        self.n_model, self.n_pipe = self.mesh.n_model, self.mesh.n_pipe
        self.n_seq = self.mesh.n_seq
        self.microbatches = int(
            (cfg.get("parallelism") or {}).get("microbatches", 0))
        if self.n_pipe > 1 and train_mode:
            self._check_pp_config(cfg)
        if self.n_seq > 1 and train_mode:
            self._check_sp_config(cfg)
        self._place(self.params, pipe=train_mode)
        self.primary = multihost.is_primary()
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
        # (device prefix table (U, P, d), image name -> row), for test()
        self._prefix_dev = None
        self._compute = steps.ComputeCopy()
        self._train_step = None
        self._eval_step = None
        self._predict_step = None

    # -- the parameters' layout ---------------------------------------------

    @staticmethod
    def _check_pp_config(cfg) -> None:
        """The JAX refusals of ``parallelism.pipe > 1``, with its message:
        pipeline parallelism covers the generative loss only."""
        problems = []
        if cfg.get("use_prediction_head") or cfg.get("use_BAN"):
            problems.append(
                "prediction-head / BAN variants are not pipelined")
        if cfg.get("exact_train_predict"):
            problems.append(
                "exact_train_predict greedy-decodes on every train batch, "
                "which is not pipelined")
        if problems:
            raise ValueError(
                "parallelism.pipe > 1 is incompatible with this config: "
                + "; ".join(problems))

    @staticmethod
    def _check_sp_config(cfg) -> None:
        """The JAX refusal of ``parallelism.seq > 1``, with its message:
        sequence parallelism covers the generative loss only."""
        if cfg.get("use_prediction_head") or cfg.get("use_BAN"):
            raise ValueError(
                "parallelism.seq > 1 is incompatible with this config: "
                "prediction-head / BAN variants are not "
                "sequence-parallelized")

    @property
    def _sharded(self) -> bool:
        return self.n_model > 1 or self.n_pipe > 1

    @property
    def _pipelined(self) -> bool:
        """The parameters are in the pipelined layout."""
        return self._layout.n_pipe > 1

    def _place(self, full: mprgen.MPRGen, pipe: bool,
               opt_state: Optional[Dict[str, Any]] = None) -> None:
        """``full`` (one process's layout) as this rank's parameters: the
        stage's blocks when ``pipe`` (and "pipe" above 1), the model
        rank's pieces; ``opt_state`` alike. New modules, so the steps'
        compute copy and flags start over."""
        self._layout = self.mesh if pipe else self.mesh.unpipelined()
        if self._sharded:
            full = pmesh.shard_params(full, self.model_cfg, self._layout)
            if opt_state is not None:
                opt_state = pmesh.shard_state(opt_state, self.model_cfg,
                                              self.mesh)
        self.params = full
        if opt_state is not None:
            self.opt_state = opt_state
        self._compute = steps.ComputeCopy()
        self._train_step = self._eval_step = self._predict_step = None

    def dense_params(self) -> mprgen.MPRGen:
        """The parameters in one process's layout (gathered from the shards:
        every process of the mesh must call this)."""
        if not self._sharded:
            return self.params
        return pmesh.gather_params(self.params, self.model_cfg,
                                   self._layout)

    def dense_opt_state(self) -> Dict[str, Any]:
        """The AdamW state in one process's layout (a collective, as
        :meth:`dense_params`)."""
        if not self._sharded:
            return self.opt_state
        return pmesh.gather_state(self.opt_state, self.model_cfg, self.mesh)

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
        if self.retrieval_index is None or self.model_cfg.use_ban:
            # the reference's BAN prompt is task prefix + question: it
            # never asks retrieval for one (quirk #9)
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
        instead of raw images. The trainable tail (the mapping, the t5-large
        projection, ``rn_proj``) still runs in the step. Returns False, leaving the image path in
        place, when the variant reads no images, ``cache_vision_tokens`` is
        0 in the config or the table would exceed ``vision_cache_max_bytes``
        (default 4 GiB)."""
        mcfg = self.model_cfg
        if not (mcfg.use_image_info or mcfg.use_ban):
            return False
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

    def stage_image_prefixes(self, entries: Sequence[dict]) -> None:
        """The device-resident visual-prefix table over the unique images
        of ``entries``: ONE vision pass per unique image; batches made with
        ``prefix_rows`` gather their rows on the device."""
        names = list(dict.fromkeys(e["image_name"] for e in entries))
        run = mprgen.cast_compute(self.params, self.model_cfg,
                                  out=self._compute.of(self.params,
                                                       self.model_cfg))
        dt = mprgen.compute_dtype(self.model_cfg)
        with torch.no_grad():
            out = encode_unique_chunks(
                names, lambda n: self.images[n],
                lambda x: torch.from_numpy(x).to(dt).to(self.device),
                lambda x: mprgen.image_prefix(run, self.model_cfg, x),
                self.batch_size)
        self._prefix_dev = (out[0] if out else None,
                            {n: i for i, n in enumerate(names)})

    def make_split_batches(self, split_name: str, shuffle: bool = False,
                           epoch: int = 0,
                           prefix_rows: bool = False) -> List[Batch]:
        """Fixed-shape batches of a split. zlib.crc32, not hash(): string
        hashing is salted per process. ``epoch`` folds into the seed so
        that each epoch draws a fresh, process-stable permutation.
        ``prefix_rows``: rows into the staged prefix table instead of
        images (:meth:`stage_image_prefixes`). The head variants carry
        ``class_labels`` (-100 on fill rows) in place of answer tokens; the
        text-only variant carries no images."""
        mcfg = self.model_cfg
        entries = self.splits[split_name]
        seed = zlib.crc32(
            f"{split_name}:{int(self.cfg.get('seed', 88))}:{epoch}".encode())
        rng = np.random.default_rng(seed) if shuffle else None
        needs_image = mcfg.use_image_info or mcfg.use_ban
        vt = self._vision_tokens
        use_vt = (not prefix_rows and needs_image and vt is not None
                  and all(e["image_name"] in vt[1] for e in entries))
        rows_of, key = ((self._prefix_dev[1], "prefix_rows") if prefix_rows
                        else (vt[1] if use_vt else None, "vision_rows"))
        return make_batches(
            entries, self.batch_size,
            encode_fn=lambda e: self.encode_entry(e, split_name),
            array_fns={key: lambda es: np.asarray(
                [rows_of[e["image_name"]] for e in es], np.int32)}
            if rows_of is not None else None,
            image_fn=(lambda es: np.stack(
                [self.images[e["image_name"]] for e in es]))
            if rows_of is None and needs_image else None,
            target_fn=None if mcfg.use_prediction_head else (
                lambda e: self.tokenizer.encode(
                    e["answer"], max_length=mcfg.max_target_length)),
            label_fn=(lambda e: e["label"]) if mcfg.use_prediction_head
            else None,
            shuffle_rng=rng,
            max_source_length=mcfg.max_source_length)

    def device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device (queued, not waited for);
        ``vision_rows`` / ``prefix_rows`` become ``vision_tokens`` /
        ``prefix`` by a device-side gather from their table."""
        out = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
               for k, v in batch.arrays.items()}
        for key, name, table in (("vision_rows", "vision_tokens",
                                  self._vision_tokens),
                                 ("prefix_rows", "prefix", self._prefix_dev)):
            rows = out.pop(key, None)
            if rows is not None:
                out[name] = table[0][rows.long()]
        return out

    # -- steps --------------------------------------------------------------

    def train_step(self):
        if self._train_step is None:
            self._train_step = steps.make_train_step(
                self.model_cfg, self.trainable, self._compute, self._par,
                self.microbatches)
        return self._train_step

    def eval_step(self):
        if self._eval_step is None:
            self._eval_step = steps.make_eval_loss_step(
                self.model_cfg, self._compute, self._par, self.microbatches)
        return self._eval_step

    def predict_step(self):
        if self._predict_step is None:
            self._predict_step = steps.make_predict_step(
                self.model_cfg, compute=self._compute, mesh=self._par)
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
        if not self.quiet and self.primary:
            print(msg)

    def train(self, resume: bool = False) -> Dict[str, Any]:
        cfg = self.cfg
        hp = cfg["hyperparameters"]
        if self.n_pipe > 1 and not self._pipelined:
            self._check_pp_config(cfg)
            self._place(self.dense_params(), pipe=True)
        if self.n_seq > 1:
            self._check_sp_config(cfg)
        if self.opt_state is None:  # experiment built with train_mode=False
            self.opt_state = adamw_init(self.params, self._moments_dtype)
        resume_meta: Dict[str, Any] = {}
        if resume:
            if not os.path.exists(self.model_path):
                raise FileNotFoundError(
                    f"resume: no checkpoint at {self.model_path}")
            template = self.opt_state
            if self._sharded:  # the one-process layout's zero moments
                template = adamw_init(self.dense_params(),
                                      self._moments_dtype)
            full, opt, resume_meta = ckpt.load_checkpoint(
                self.model_path, self.model_cfg, template, self.device)
            # the rank's shards of the parameters and of the AdamW state
            self._place(full, pipe=True, opt_state=opt)
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

        # the reference predicts every training batch for the head
        # variants' train accuracy (quirk #5), before the batch's update
        track_acc = self.model_cfg.use_prediction_head
        for epoch in range(hp["epochs"]):
            self.log(f"Starting epoch {epoch} ...")
            self.log(f"The learning rate is now {scheduler.lr}")
            batches = self.make_split_batches("train", shuffle=True,
                                              epoch=epoch)
            t0 = time.time()
            epoch_losses, correct = [], []
            # prefetch: ship batch i + 1 while step i runs
            nxt = self.device_batch(batches[0]) if batches else None
            for i, b in enumerate(batches):
                db = nxt
                if i + 1 < len(batches):
                    nxt = self.device_batch(batches[i + 1])
                if track_acc:
                    # fill rows are labelled -100, which no class id equals
                    preds = self.predict_step()(self.params, db)
                    correct.append(torch.sum(preds == db["class_labels"]))
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
            if correct and n_train:
                self.log("Train acc is: "
                         f"{float(torch.stack(correct).sum()) / n_train}")
            self.log(f"Train loss is {train_total / max(n_train, 1)} "
                     f"({time.time() - t0:.1f}s)")
            valid_loss = self.validation_loss(val_batches)
            scheduler.step(valid_loss)
            self.log(f"Validation Loss: {valid_loss} | Best Validation "
                     f"Loss: {best_valid} at epoch {best_epoch}")
            if valid_loss < best_valid:
                self.log(f"Saving model to {self.model_path} ...")
                # checkpoint_save_optimizer=0 drops the AdamW moments from
                # the file; a resume restarts with fresh moments. Sharded
                # ranks gather the one-process layout first (collectives)
                params = self.dense_params()
                opt = (self.dense_opt_state() if cfg.get(
                    "checkpoint_save_optimizer", True) else None)
                if self.primary:  # one writer per shared file system
                    ckpt.save_checkpoint(
                        self.model_path, params, self.model_cfg, opt,
                        metadata={"epoch": epoch, "valid_loss": valid_loss,
                                  "lr": scheduler.lr, "config": cfg})
                del params, opt
                multihost.barrier()
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

        result = {"best_valid_loss": best_valid, "best_epoch": best_epoch,
                  "parameter_updates": parameter_updates,
                  "train_losses": train_losses,
                  "valid_losses": valid_losses}
        if not self.primary:  # one writer of the loss logs
            return result
        train_info_path = os.path.join(self.log_root, self.model_prefix)
        os.makedirs(train_info_path, exist_ok=True)
        for name, rows in (("training_loss.txt", train_losses),
                           ("validation_loss.txt", valid_losses)):
            with open(os.path.join(train_info_path, name), "w") as f:
                f.write("parameter_updates,loss\n")
                for u, loss in rows:
                    f.write(f"{u},{loss}\n")
        return result

    def load_weights(self) -> None:
        """The parameters of the checkpoint at ``model_path``, in the
        un-pipelined layout (tensor-parallel pieces under "model")."""
        full, _, _ = ckpt.load_checkpoint(self.model_path, self.model_cfg,
                                          device=self.device)
        self._place(full, pipe=False)

    def test(self, load: bool = True) -> TestMetrics:
        """The answers over the test split (greedy ids, or class ids for
        the head variants), scored as the reference scores them; the metrics are logged and written under
        ``log_root``. ``load`` takes the weights of ``model_path`` (and
        raises ``FileNotFoundError`` when there is none: silently scoring
        random weights would be worse). Runs un-pipelined: after a
        pipelined train, from a dense copy of the parameters."""
        if load:
            if not os.path.exists(self.model_path):
                raise FileNotFoundError(
                    f"no checkpoint at {self.model_path}; train first or "
                    "pass load=False")
            self.load_weights()
        elif self._pipelined:
            self._place(self.dense_params(), pipe=False)
        mcfg = self.model_cfg
        test_entries = self.splits["test"]
        if self.retrieval_index is not None:
            self.retrieval_index.is_training_phase = False
            self.precompute_hints("test")
            test_q = self._query_embeddings("test")
            qpos = {e["question_id"]: i for i, e in enumerate(test_entries)}
        metrics = TestMetrics(retrieval_k=self.k)
        run = self._compute.of(self.params, mcfg)
        if (not mcfg.use_prediction_head and mcfg.use_image_info
                and self.cfg.get("cache_image_prefix", True)):
            # serve-style staging: the prefix table stays on the device and
            # batches gather their rows there
            self.stage_image_prefixes(test_entries)
            batches = self.make_split_batches("test", prefix_rows=True)
            par = self._par

            def predict(db):
                local = db if par is None else pmesh.shard_batch(db, par)
                ids = generative_predict_from_prefix(
                    run, mcfg, local["prefix"], local["input_ids"],
                    local["text_mask"], tp=pmesh.tp_axis(par))
                return ids if par is None else pmesh.gather_rows(ids, par)
        else:
            batches = self.make_split_batches("test")
            step = self.predict_step()

            def predict(db):
                return step(self.params, db)
        diagnostics = (self.retrieval_index is not None
                       and not mcfg.use_prediction_head)
        if diagnostics:
            # ONE top-k over the whole split for the diagnostics; answers
            # and types are host gathers from the same index rows
            _, tidx = self.retrieval_index.topk(test_q, k=self.k)
            tidx = tidx.cpu().numpy()
            r_answers = self.retrieval_index.answers
            r_qtypes = self.retrieval_index.question_info["question_type"]
        test_ds = self.datasets["test"]
        with torch.no_grad():
            # one batch in flight: dispatch i + 1 before fetching i
            pending = [predict(self.device_batch(b)) for b in batches[:1]]
            for i, b in enumerate(batches):
                if i + 1 < len(batches):
                    pending.append(predict(self.device_batch(batches[i + 1])))
                preds = pending.pop(0).cpu().numpy()
                for j, entry in enumerate(b.entries):
                    if not b.valid[j]:
                        continue
                    if mcfg.use_prediction_head:
                        metrics.add_classification(int(preds[j]), entry)
                        continue
                    answer = self.tokenizer.decode(preds[j],
                                                   skip_special_tokens=True)
                    metrics.add_generative(
                        answer, entry,
                        test_ds.get_closest_label(answer.lower()))
                    if diagnostics:
                        row = tidx[qpos[entry["question_id"]]]
                        metrics.add_retrieval_diagnostics(
                            answer, entry, [r_answers[x] for x in row],
                            [r_qtypes[x] for x in row])
        self.log(metrics.report())
        if self.primary:
            metrics.write_artifacts(self.log_root, self.model_prefix)
        return metrics


def run_from_config(config_path: str, *, train: bool = False,
                    resume: bool = False, test: bool = False,
                    model_file: Optional[str] = None, **kw):
    """The CLI's verbs on a JSON config: build the experiment (``kw`` goes
    to :class:`TrainingExperiment`, ``device`` included), then train or
    resume, then test. Returns (experiment, {"train": ..., "test": ...})."""
    with open(config_path) as f:
        cfg = json.load(f)
    exp = TrainingExperiment(cfg, train_mode=train or resume,
                             model_file=model_file, **kw)
    results = {}
    if train or resume:
        results["train"] = exp.train(resume=resume)
    if test:
        results["test"] = exp.test()
    return exp, results


def north_star_train_setup(seed: int = 0,
                           device: Optional[torch.device] = None, *,
                           params: Optional[mprgen.MPRGen] = None,
                           config: Optional[Dict[str, Any]] = None,
                           **kw) -> TrainingExperiment:
    """The JAX ``bench.py`` train stage at full width: t5-small + CLIP
    ViT-B/32, ``attention_impl="row"`` in both towers and the encoder, fp32
    masters with bf16 compute, B=128, dropout 0.1, retrieval k=1 with the
    quantifier, seeded random weights (or ``params``); synthetic SLAKE with
    410 corpus images x 3 QA = 1,230 training entries (prompts of at most 32
    tokens behind the 50-token prefix, answers of at most 8) and 8
    validation images. ``config``: keys set over the config (a variant's).
    ``kw`` goes to :class:`TrainingExperiment`."""
    splits, images = synthetic_slake(410, 0, image_size=224, seed=seed,
                                     n_validate=8)
    cfg = synthetic_config(batch_size=128, epochs=1, retrieval=True, k=1,
                           image_size=224)
    cfg.update(seed=seed, compute_dtype="bfloat16",
               **copy.deepcopy(SERVE_PATHS["main"]))
    cfg["hyperparameters"]["learning_rate"] = 1e-4
    cfg.update(config or {})
    return TrainingExperiment(cfg, train=splits["train"],
                              validate=splits["validate"], images=images,
                              params=params, device=device, **kw)


# the JAX bench.py trainer overrides of t5-large (its
# _t5_large_trainer_overrides): the head-layout T5 with each layer
# recomputed in the backward pass, bf16 AdamW moments (fp32 math), and a
# checkpoint of the parameters alone
T5_LARGE_TRAINER = {"t5_overrides": {"attention_impl": "xla", "remat": True},
                    "adamw_moments_dtype": "bfloat16",
                    "checkpoint_save_optimizer": 0}


def north_star_t5_large_train_setup(seed: int = 0,
                                    device: Optional[torch.device] = None,
                                    **kw) -> TrainingExperiment:
    """The JAX ``bench.py`` ``t5_large`` stage's trainer at full width: the
    load of :func:`~multimodalpromptretrieval_tpu_torch.serving.
    t5_large_load` under :data:`T5_LARGE_TRAINER`, B=64, one epoch at the
    synthetic config's learning rate (1e-3) and dropout 0.1, seeded random
    weights. ``train()`` writes the parameters-only checkpoint where
    :func:`~multimodalpromptretrieval_tpu_torch.serving.
    north_star_t5_large_setup` with the same ``model_root`` finds it.
    ``kw`` goes to :class:`TrainingExperiment`."""
    cfg, splits, images = t5_large_load(seed)
    cfg.update(copy.deepcopy(T5_LARGE_TRAINER))
    cfg["hyperparameters"]["batch_size"] = 64
    return TrainingExperiment(cfg, train=splits["train"],
                              validate=splits["validate"],
                              test=splits["test"], images=images,
                              device=device, **kw)
