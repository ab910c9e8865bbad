"""The port's parallel checks: one process of a group, or the same work in
one process to compare with.

    python tests/torch_multihost_worker.py \\
        --load tiny|train|tp|pp|tp_pp|sp|serve \\
        --rank R --world W --port P --root DIR [--seed S] [--par NAME]

joins a process group of W processes (``parallel/multihost``: gloo on the
CPU and for processes that share one card, NCCL when each has a card),
runs :func:`run` and writes ``{root}/rank{R}.npz``, its logs under
``{root}/rank{R}/`` and checkpoints in ``{root}/models`` (shared, as a file
system is across hosts). ``tests/test_torch_parallel.py`` starts two
processes on the "tiny" load on the CPU, ``chip_smoke.py``'s parallel phase
two on the "train" load on one card, and each compares them with
:func:`run` in one process.

The loads: "tiny" is a small fp32 experiment (row attention, retrieval k=2,
B=8) on an in-memory synthetic SLAKE; "train" is the train phase of
``chip_smoke.py`` at full width (t5-small + CLIP ViT-B/32, B=128, L=82,
T=8), at fp32 with dropout 0 for the compared steps and at bf16 with
dropout 0.1 for the timed ones. What :func:`run` drives:

* three train steps on the first shuffled batch at each compared dropout
  rate: the losses, the parameters after, the gradients of step 1 as AdamW
  receives them (summed over the group), and with ``blocks`` those of the
  batch's ``blocks`` row blocks, each weighted by its share of the valid
  targets, computed and summed in this one process: the data-parallel sum
  over GEMMs of a process's shape;
* on a card: 2 + 10 timed steps, and with a group one ``all_reduce`` of the
  step's gradient floats alone;
* tiny: one epoch of ``train()`` and its ``test()``, with this process's
  checkpoint writes counted; train: ``test()`` at fp32 of the checkpoint
  under ``{inputs}/cfg.json`` (written by the cli phase);
* ``sharded_l2_topk`` over the group, or one ``ops/topk.l2_topk`` without
  one, for each (k, skip_first) case over each index, with the kernel
  launches counted from 0 around that loop alone.

The model-parallel loads (:func:`run_model_parallel`) run tensor, pipeline
or both parallelisms (``MODEL_PARALLEL``): "tp", "pp", "tp_pp" on the CPU,
on the JAX package's tiny configurations (``tests/test_torch_tensor_
parallel.py`` and ``tests/test_torch_pipeline.py`` write the inputs and
hold the results against the JAX steps and one process), and "train"
with ``--par`` on the card (``chip_smoke.py``'s model_parallel phase).

Sequence parallelism (:func:`run_sequence`, the "sp" load: four processes
as data 2 x seq 2 on the JAX ``tests/test_sequence.py`` configuration,
written by ``tests/test_torch_sequence.py``) and the data-sharded server
(:func:`run_serve`, the "serve" load: two processes under ``{"data": 2}``
on the configurations ``tests/test_torch_sharded_serve.py`` writes); on
the card ``--load train --par sp`` (:func:`run_card_sp`) and ``--par
serve`` (:func:`run_card_serve`), ``chip_smoke.py``'s seq_parallel and
sharded_serve phases.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodalpromptretrieval_tpu_torch import cli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.t5 import (  # noqa: E402
    T5Config,
    t5_encode,
    t5_greedy_decode,
)
from multimodalpromptretrieval_tpu_torch.ops import _build  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.layers import BatchShard  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import (  # noqa: E402
    mesh as pmesh,
    multihost,
    pipeline as ppipe,
    retrieval as pretrieval,
    sequence as psequence,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    SERVE_PATHS,
    ServingExperiment,
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import step as steps  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
    north_star_train_setup,
)
from multimodalpromptretrieval_tpu_torch.train.optim import adamw_init  # noqa: E402

LOADS = ("tiny", "train", "tp", "pp", "tp_pp", "sp", "serve")
# the model- and sequence-parallel loads: their parallelism key, processes,
# and the T5 layers of the JAX tests' tiny configurations
# (tests/test_parallel.py, tests/test_pipeline.py, tests/test_sequence.py);
# "sp" over four processes is data 2 x seq 2
MODEL_PARALLEL = {
    "tp": ({"model": 2}, 2, 2),
    "pp": ({"pipe": 2}, 2, 4),
    "tp_pp": ({"pipe": 2, "model": 2}, 4, 4),
    "sp": ({"seq": 2}, 4, 4),
}
# the card's model-parallel configurations (chip_smoke.py): parallelism,
# processes, the T5 attention_impl, the microbatches of the compared steps
# (0: the stage count), whether test() runs
CARD_PARALLEL = {
    "tp": ({"model": 2}, 2, "row", (0,), True),
    "pp": ({"pipe": 2}, 2, "pallas", (2, 4), True),
    "tp_pp": ({"pipe": 2, "model": 2}, 4, "pallas", (0,), False),
}
# the dropout rates of the compared fp32 steps
RATES = {"tiny": (0.0, 0.1), "train": (0.0,)}
# the (k, skip_first) cases of the top-k
TOPK_CASES = {
    "tiny": ((1, False), (1, True), (3, False), (4, True), (9, False)),
    "train": ((1, False), (1, True), (15, False), (15, True), (64, False),
              (64, True)),
}
STEPS, WARMUP, TIMED = 3, 2, 10
# the rows of the train load's random index beside its 1,230-row corpus
TRAIN_TOPK_ROWS = 5000


def tiny_experiment(logs: str, models: str,
                    rate: float) -> TrainingExperiment:
    """The tiny fp32 experiment on 18 train, 6 validation and 6 test
    entries, writing its logs under ``logs`` and checkpoint under
    ``models``."""
    splits, images = synthetic_slake(6, 2, image_size=32, seed=0,
                                     n_validate=2)
    cfg = synthetic_config(batch_size=8, epochs=1, retrieval=True, k=2,
                           image_size=32)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    cfg["t5_overrides"].update(attention_impl="row", dropout_rate=rate,
                               vocab_size=128)
    return TrainingExperiment(
        cfg, train=splits["train"], validate=splits["validate"],
        test=splits["test"], images=images, device="cpu", quiet=True,
        log_root=logs, model_root=models)


def train_experiment(seed: int, dev, fp32: bool, params=None,
                     parallelism=None, impl: str = "row"
                     ) -> TrainingExperiment:
    """The train load (bf16 compute, dropout 0.1), or with ``fp32`` at fp32
    and dropout 0; with ``parallelism`` and the T5 ``attention_impl``
    ``impl`` (the model-parallel configurations)."""
    config = {}
    if fp32:
        config = {"compute_dtype": "float32", "t5_overrides": dict(
            SERVE_PATHS["main"]["t5_overrides"], dropout_rate=0.0)}
    if parallelism is not None:
        config["parallelism"] = parallelism
    if impl != "row":
        t5 = dict(config.get("t5_overrides",
                             SERVE_PATHS["main"]["t5_overrides"]))
        config["t5_overrides"] = dict(t5, attention_impl=impl)
    return north_star_train_setup(seed, dev, params=params,
                                  config=config or None, quiet=True)


def first_batch(exp: TrainingExperiment) -> dict:
    """Hints and the vision-token table made; the first shuffled train
    batch on the device."""
    exp.retrieval_index.is_training_phase = True
    exp.precompute_hints("train")
    exp.build_vision_token_cache("train", "validate")
    return exp.device_batch(exp.make_split_batches(
        "train", shuffle=True, epoch=0)[0])


def topk_data():
    """An integer-valued (37, 8) index (exact fp32 distances) with repeated
    rows, so that equal distances occur, and 6 queries, two of them index
    rows (a zero distance for ``skip_first`` to drop)."""
    rng = np.random.default_rng(7)
    index = rng.integers(-3, 4, size=(37, 8)).astype(np.float32)
    index[30] = index[5]
    index[11] = index[10]
    index[36] = index[10]
    query = rng.integers(-3, 4, size=(6, 8)).astype(np.float32)
    query[0], query[3] = index[10], index[5]
    return torch.from_numpy(query), torch.from_numpy(index)


def train_topk_inputs(exp: TrainingExperiment, seed: int) -> dict:
    """The train load's top-k inputs (written once, then read by every
    process): a (512, D) normal query over the experiment's retrieval
    corpus and over a 5,000-row normal index."""
    gen = torch.Generator().manual_seed(seed)
    corpus = exp.retrieval_index.embeddings.float().cpu()
    n, d = corpus.shape
    return {"query": torch.randn(512, d, generator=gen),
            "indexes": {n: corpus, TRAIN_TOPK_ROWS: torch.randn(
                TRAIN_TOPK_ROWS, d, generator=gen)}}


def _params(exp) -> dict:
    return {n: p.detach().cpu().numpy().copy()
            for n, p in exp.params.named_parameters()}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def block_grads(exp, batch, blocks: int) -> dict:
    """The step-1 gradients of ``blocks`` row blocks of ``batch`` in this
    process, each block's loss weighted by its share of the valid targets
    and drawn with the dropout masks a process of that block draws, summed
    in fp32 (the fp32 masters are the compute model)."""
    cfg = exp.model_cfg
    mprgen.set_trainable(exp.params, exp.trainable)
    gen = exp.dropout_gen
    state = gen.get_state()
    total = {}
    for r in range(blocks):
        gen.set_state(state)
        local = pmesh.shard_batch(batch, pmesh.Mesh(blocks, rank=r))
        loss = (mprgen.loss_fn(exp.params, cfg, local,
                               BatchShard(gen, r, blocks),
                               compute=exp.params)
                * pmesh.loss_weight(cfg, batch, local))
        for n, g in steps.backward(loss, exp.params).items():
            if g is not None:
                total[n] = total.get(n, 0) + g.detach().float()
    gen.set_state(state)
    return {n: g.cpu().numpy() for n, g in total.items()}


def relu_flips(exp, batch, blocks: int) -> dict:
    """The ReLU gates of every T5 ``ff.wi`` that one forward of the whole
    ``batch`` and the forwards of its ``blocks`` row blocks (the
    microbatches' GEMM row counts) set apart, on the fp32 masters without
    dropout: by the weight's name, (gates that differ, gates)."""
    cfg, t5 = exp.model_cfg, exp.params.t5
    seen, hooks = {}, []
    for stack in ("encoder", "decoder"):
        for i, p in enumerate(getattr(t5, stack).block):
            hooks.append(p.ff.wi.register_forward_hook(
                lambda mod, args, out, n=f"t5.{stack}.block.{i}.ff.wi.weight":
                seen.setdefault(n, []).append(out > 0)))
    try:
        with torch.no_grad():
            mprgen.loss_fn(exp.params, cfg, batch, compute=exp.params)
            whole = {n: v.pop() for n, v in seen.items()}
            for r in range(blocks):
                mprgen.loss_fn(exp.params, cfg, pmesh.shard_batch(
                    batch, pmesh.Mesh(blocks, rank=r)), compute=exp.params)
    finally:
        for h in hooks:
            h.remove()
    return {n: (int((torch.cat(v) != whole[n]).sum()), whole[n].numel())
            for n, v in seen.items()}


def decode_ids(exp, batch, tp=None) -> np.ndarray:
    """Greedy ids of ``batch`` for 20 steps with ``early_stop`` off, on the
    parameters cast to the compute dtype: the tensor-parallel decode on
    the rank's shards under ``tp`` (the "model" axis)."""
    cfg = exp.model_cfg
    run = mprgen.cast_compute(exp.params, cfg)
    images, tokens = mprgen._batch_visual(batch, cfg)
    with torch.no_grad():
        embeds, mask = mprgen.combine_inputs(
            run, cfg, images, batch["input_ids"], batch["text_mask"], tokens)
        enc = t5_encode(run.t5, cfg.t5, embeds, mask, tp=tp)
        ids = t5_greedy_decode(run.t5, cfg.t5, enc, mask, max_new_tokens=20,
                               early_stop=False, tp=tp)
    return ids.cpu().numpy()


def tp_decodes(par: dict) -> bool:
    """A card configuration whose ranks hold :func:`decode_ids` under TP
    against one process: "model" without "pipe"."""
    return par.get("model", 1) > 1 and par.get("pipe", 1) == 1


def compared_steps(exp, batch, blocks: int) -> dict:
    """Losses of STEPS steps, every parameter after, the step-1
    gradients as AdamW receives them, the kernel launches a step, and with
    ``blocks`` :func:`block_grads`."""
    out = {}
    if blocks:
        out["blocks"] = block_grads(exp, batch, blocks)
    step = exp.train_step()
    lr = exp.cfg["hyperparameters"]["learning_rate"]
    before = _build.launch_counts()
    with first_grads() as seen:
        losses = [float(step(exp.params, exp.opt_state, batch, lr,
                             exp.dropout_gen)) for _ in range(STEPS)]
    after = _build.launch_counts()
    out.update(losses=np.asarray(losses), params=_params(exp),
               grad=_numpy(seen[0]),
               launches={k: (after[k] - before[k]) // STEPS for k in after
                         if after[k] != before[k]})
    return out


def timed_ms(exp, batch) -> float:
    """ms a step over TIMED steps after WARMUP, synced."""
    step = exp.train_step()
    lr = exp.cfg["hyperparameters"]["learning_rate"]
    for i in range(WARMUP + TIMED):
        if i == WARMUP:
            _sync(exp.device)
            t0 = time.perf_counter()
        step(exp.params, exp.opt_state, batch, lr, exp.dropout_gen)
    _sync(exp.device)
    return 1e3 * (time.perf_counter() - t0) / TIMED


def all_reduce_ms(floats: int, dev) -> float:
    """ms of one ``all_reduce`` of ``floats`` fp32 zeros, after two."""
    flat = torch.zeros(floats, device=dev)
    for _ in range(2):
        torch.distributed.all_reduce(flat)
    _sync(dev)
    t0 = time.perf_counter()
    torch.distributed.all_reduce(flat)
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0)


def fit_and_test(load: str, logs: str, models: str, inputs, dev) -> dict:
    """tiny: one epoch of ``train()`` and its ``test()``, with the per-epoch
    train and validation losses, the parameters and this process's
    checkpoint writes; train: ``test()`` at fp32 of the cli checkpoint,
    timed."""
    if load == "train":
        with open(os.path.join(inputs, "cfg.json")) as f:
            cfg = json.load(f)
        cfg["compute_dtype"] = "float32"
        exp = TrainingExperiment(cfg, device=dev, train_mode=False,
                                 quiet=True, log_root=logs,
                                 model_root=models)
        t0 = time.perf_counter()
        overall = exp.test().overall
        _sync(dev)
        return {"test/overall": np.asarray(overall),
                "test/s": np.asarray(time.perf_counter() - t0)}
    saves = []
    save = ckpt.save_checkpoint

    def counted(path, *a, **kw):
        saves.append(path)
        return save(path, *a, **kw)

    ckpt.save_checkpoint = counted
    try:
        exp = tiny_experiment(logs, models, 0.0)
        fit = exp.train()
        res = {"test/overall": np.asarray(exp.test().overall)}
    finally:
        ckpt.save_checkpoint = save
    res["train/losses"] = np.asarray(
        [x for _, x in fit["train_losses"] + fit["valid_losses"]])
    res.update({f"train/{n}": v for n, v in _params(exp).items()})
    res["saves"] = np.asarray(len(saves))
    return res


def sharded_topk(load: str, inputs, dev) -> dict:
    """Each (k, skip_first) case over each index: ``sharded_l2_topk`` over
    the group, or one ``l2_topk`` in a single process; the kernel launches
    of the loop alone."""
    if load == "tiny":
        query, index = topk_data()
        indexes = {len(index): index}
    else:
        data = torch.load(os.path.join(inputs, "topk_inputs.pt"))
        query, indexes = data["query"], data["indexes"]
    query = query.to(dev)
    mesh = pmesh.Mesh(multihost.process_count())
    res = {}
    _build.reset_launch_counts()
    for n, index in indexes.items():
        index = index.to(dev)
        if mesh.n_data > 1:
            index, n_valid = pretrieval.pad_index_for_mesh(index, mesh)
        for k, skip in TOPK_CASES[load]:
            if mesh.n_data > 1:
                d, i = pretrieval.sharded_l2_topk(query, index, n_valid, k,
                                                  mesh=mesh, skip_first=skip)
            else:
                d, i = l2_topk(query, index, k, skip_first=skip)
            res[f"topk{n}_{k}{skip}/d"] = d.cpu().numpy()
            res[f"topk{n}_{k}{skip}/i"] = i.cpu().numpy()
    _sync(dev)
    res["topk/launches"] = np.asarray(_build.launch_counts()["l2_topk"])
    return res


def run(load: str, logs: str, models: str, *, inputs: str = None,
        seed: int = 0, dev="cpu", blocks: int = 0) -> dict:
    """The results as arrays by name: ``steps{rate}/losses``,
    ``steps{rate}/<param>``, ``grad{rate}/<param>`` (step 1) and with
    ``blocks`` ``blocks{rate}/<param>``, ``launches/<kernel>`` (a step);
    on a card ``ms`` (a timed step) and with a group ``all_reduce_ms``;
    :func:`fit_and_test`'s and :func:`sharded_topk`'s; ``total/<kernel>``,
    the launches of the whole run. ``inputs`` is the
    train load's directory of ``cfg.json`` and ``topk_inputs.pt``."""
    res = {}
    exp = None
    for rate in RATES[load]:
        exp = (tiny_experiment(logs, models, rate) if load == "tiny"
               else train_experiment(seed, dev, fp32=True))
        out = compared_steps(exp, first_batch(exp), blocks)
        res[f"steps{rate}/losses"] = out["losses"]
        for key, prefix in (("params", "steps"), ("grad", "grad"),
                            ("blocks", "blocks")):
            res.update({f"{prefix}{rate}/{n}": v
                        for n, v in out.get(key, {}).items()})
        res.update({f"launches/{k}": np.asarray(v)
                    for k, v in out["launches"].items()})
    if torch.device(dev).type == "cuda":
        floats = sum(p.numel() for n, p in exp.params.named_parameters()
                     if exp.trainable[n])
        if multihost.process_count() > 1:
            res["all_reduce_ms"] = np.asarray(all_reduce_ms(floats, dev))
        if load == "train":
            exp = train_experiment(seed, dev, fp32=False, params=exp.params)
        res["ms"] = np.asarray(timed_ms(exp, first_batch(exp)))
    del exp
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    res.update(fit_and_test(load, logs, models, inputs, dev))
    counts = _build.launch_counts()
    res.update(sharded_topk(load, inputs, dev))
    after = _build.launch_counts()
    res.update({f"total/{k}": np.asarray(counts[k] + after[k])
                for k in after})
    return res


# ---------------------------------------------------------------------------
# Tensor and pipeline parallelism
# ---------------------------------------------------------------------------


def tiny_model_cfg(layers: int, rate: float = 0.0) -> mprgen.MPRGenConfig:
    """The JAX tests' tiny MPRGen (``tests/test_parallel.py``,
    ``tests/test_pipeline.py``) at dropout ``rate``."""
    return mprgen.MPRGenConfig(
        t5=T5Config(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                    num_layers=layers, num_decoder_layers=layers,
                    num_heads=4, dropout_rate=rate),
        clip=CLIPConfig(embed_dim=32, image_resolution=32, vision_width=32,
                        vision_layers=1, patch_size=16, context_length=8,
                        vocab_size=64, text_width=32,
                        vision_heads_override=2, text_heads_override=2))


@contextlib.contextmanager
def first_grads():
    """The gradients of the first update as AdamW receives them (merged
    over the mesh), by the rank's names, in the list yielded."""
    seen = []
    update = steps.adamw_update

    def capture(params, grads, *a, **kw):
        if not seen:
            seen.append({n: g.detach().float().cpu().clone()
                         for n, g in grads.items() if g is not None})
        return update(params, grads, *a, **kw)

    steps.adamw_update = ppipe.adamw_update = capture
    psequence.adamw_update = capture
    try:
        yield seen
    finally:
        steps.adamw_update = ppipe.adamw_update = update
        psequence.adamw_update = update


def _numpy(tensors) -> dict:
    return {n: t.detach().float().cpu().numpy() for n, t in tensors.items()}


def model_steps(cfg, params, batch, mesh, n: int, gen=None,
                microbatches: int = 0, lr: float = 1e-3):
    """``n`` train steps from fresh AdamW moments: (losses, the step-1
    gradients by the rank's names)."""
    step = steps.make_train_step(cfg, mprgen.trainable_mask(params, cfg),
                                 mesh=mesh, microbatches=microbatches)
    opt = adamw_init(params)
    with first_grads() as seen:
        losses = [float(step(params, opt, batch, lr, gen))
                  for _ in range(n)]
    return np.asarray(losses), seen[0]


def run_model_parallel(load: str, root: str, seed: int = 0) -> dict:
    """A tiny model-parallel load in the group, on the inputs the test wrote
    (``{root}/mp_inputs.pt``: the JAX init as the port's state and a
    batch of 16): one step at dropout 0 (the loss, the parameters after,
    gathered; the step-1 gradients beside one process's, cut to this
    rank's pieces), the shard -> gather round trip, with "pipe" the eval
    loss over 4 microbatches, with "model" the tensor-parallel greedy ids
    (5 tokens), and three steps at dropout 0.1 against one process's (the
    losses, this rank's parameters after)."""
    par, _, layers = MODEL_PARALLEL[load]
    data = torch.load(os.path.join(root, "mp_inputs.pt"))
    batch = data["batch"]
    cfg = tiny_model_cfg(layers)
    full = mprgen.MPRGen(cfg)
    full.load_state_dict(data["state"])
    mesh = pmesh.build_mesh({"parallelism": par, "hyperparameters": {
        "batch_size": len(batch["labels"])}})
    res = {}
    local = pmesh.shard_params(full, cfg, mesh)
    back = pmesh.gather_params(local, cfg, mesh)
    res["roundtrip"] = np.asarray(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            full.named_parameters(), back.named_parameters())))
    ref = copy.deepcopy(full)
    _, want = model_steps(cfg, ref, batch, None, 1)
    res["step/loss"], grads = model_steps(cfg, local, batch, mesh, 1)
    res.update({f"step/{n}": v for n, v in _numpy(dict(
        pmesh.gather_params(local, cfg, mesh).named_parameters())).items()})
    res.update({f"grad/{n}": v for n, v in _numpy(grads).items()})
    res.update({f"gradref/{n}": v for n, v in _numpy(
        pmesh.shard_tensors(want, cfg.t5, mesh)).items()})
    if mesh.n_pipe > 1:
        res["eval4/loss"] = np.asarray(float(steps.make_eval_loss_step(
            cfg, mesh=mesh, microbatches=4)(
                pmesh.shard_params(full, cfg, mesh), batch)))
        res["eval4/ref"] = np.asarray(float(
            steps.make_eval_loss_step(cfg)(full, batch)))
    if mesh.n_model > 1:
        pbatch = {k: v for k, v in batch.items() if k != "labels"}
        res["predict/ids"] = steps.make_predict_step(
            cfg, max_new_tokens=5, mesh=mesh)(
                pmesh.shard_params(full, cfg, mesh.unpipelined()),
                pbatch).numpy()
        res["predict/ref"] = steps.make_predict_step(
            cfg, max_new_tokens=5)(full, pbatch).numpy()
    if mesh.n_pipe == 1:
        res.update(head_variants(batch, mesh, seed))
    dcfg = tiny_model_cfg(layers, 0.1)
    res["drop/ref"], _ = model_steps(
        dcfg, copy.deepcopy(full), batch, None, STEPS,
        torch.Generator().manual_seed(seed))
    local = pmesh.shard_params(full, dcfg, mesh)
    res["drop/losses"], _ = model_steps(
        dcfg, local, batch, mesh, STEPS, torch.Generator().manual_seed(seed))
    res.update({f"after/{n}": v for n, v in _numpy(
        dict(local.named_parameters())).items()})
    return res


def head_variants(batch, mesh, seed: int) -> dict:
    """The prediction-head and BAN variants (5 classes) under the mesh's
    tensor parallelism: three steps at dropout 0.1 from a seeded init (the
    losses, and the step-1 gradients beside one process's cut to the
    rank's pieces) and one process's losses."""
    res = {}
    labels = torch.arange(len(batch["labels"])) % 5
    labels[-1] = -100
    hbatch = dict({k: v for k, v in batch.items() if k != "labels"},
                  class_labels=labels)
    for name, ban in (("head", False), ("ban", True)):
        cfg = dataclasses.replace(tiny_model_cfg(2, 0.1),
                                  use_prediction_head=True, use_ban=ban,
                                  num_classes=5)
        full = mprgen.init_mprgen(cfg, seed)
        res[f"{name}/ref"], want = model_steps(
            cfg, copy.deepcopy(full), hbatch, None, STEPS,
            torch.Generator().manual_seed(1))
        res[f"{name}/losses"], grads = model_steps(
            cfg, pmesh.shard_params(full, cfg, mesh), hbatch, mesh, STEPS,
            torch.Generator().manual_seed(1))
        want = pmesh.shard_tensors(want, cfg.t5, mesh)
        # each leaf's largest difference past 1e-5 of its largest value (a
        # leaf the variant does not reach, the decoder's, is a zero sum;
        # BAN's h_bias shifts a softmax: its gradient is rounding noise)
        res[f"{name}/grad_excess"] = np.asarray(max(
            float((g - want.get(n, torch.zeros_like(g))).abs().max())
            - 1e-5 * float(want.get(n, g).abs().max())
            for n, g in grads.items()))
    return res


def cli_runs(load: str, root: str, rank: int, world: int, ports) -> None:
    """``cli.main --train --test`` (2 epochs) and then ``--resume --test``
    under the load's parallelism, each a process group of its own over the
    multihost flags, in ``{root}/{load}``: logs and the checkpoint under
    ``logs`` / ``models`` there, the first run's logs moved to
    ``logs_first`` by rank 0 before the resume."""
    work = os.path.join(root, load)
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    for verb, port in (("--train", ports[1]), ("--resume", ports[2])):
        if verb == "--resume" and rank == 0:
            os.rename("logs", "logs_first")
        cli.main([verb, "--test", "--config",
                  os.path.join(root, f"cfg_{load}.json"), "--device", "cpu",
                  "--coordinator", f"localhost:{port}", "--num_processes",
                  str(world), "--process_id", str(rank)])


def free_ports(n: int) -> list:
    """``n`` distinct free ports of this host."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def spawn(load: str, root: str, world: int, *, par: str = None,
          seed: int = 0):
    """Start the ``world`` processes of a load (their output piped)."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT")}
    ports = ",".join(map(str, free_ports(3)))
    extra = ["--par", par] if par else []
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--load", load,
         "--rank", str(r), "--world", str(world), "--port", ports,
         "--root", root, "--seed", str(seed)] + extra, env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(procs, timeout: float) -> list:
    """Wait for the processes (all of them killed past ``timeout``
    seconds); the output of each that failed, as text."""
    import subprocess

    deadline = time.time() + timeout
    fail = []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                fail.append(f"--- rank {r} timed out ---\n{out[-6000:]}")
                continue
            if p.returncode:
                fail.append(f"--- rank {r} rc={p.returncode} ---\n"
                            f"{out[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return fail


def write_cli_inputs(root: str, loads) -> str:
    """The synthetic SLAKE on disk under ``root`` (24 train, 8 validation, 8
    test images, 3 QA each, 32 px) and its config at dropout 0 (the JAX
    ``tests/test_parallelism_config.py`` load): ``{root}/cfg.json`` for one
    process and ``{root}/cfg_{load}.json`` with each load's
    parallelism."""
    from multimodalpromptretrieval_tpu_torch.data.synthetic import (
        generate_synthetic_slake,
        synthetic_config,
    )

    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=24,
                             n_validate=8, n_test=8, image_size=32, seed=3)
    cfg = synthetic_config(root, batch_size=8, epochs=2, image_size=32)
    cfg["clip_overrides"].update(image_resolution=32, patch_size=16)
    cfg["t5_overrides"]["dropout_rate"] = 0.0
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    for load in loads:
        with open(os.path.join(root, f"cfg_{load}.json"), "w") as f:
            json.dump(dict(cfg, parallelism=MODEL_PARALLEL[load][0]), f)
    return path


def read_losses(logs: str) -> np.ndarray:
    """The train and validation losses a run wrote under ``logs``."""
    (prefix,) = [d for d in os.listdir(logs)
                 if os.path.isdir(os.path.join(logs, d))]
    out = []
    for name in ("training_loss.txt", "validation_loss.txt"):
        with open(os.path.join(logs, prefix, name)) as f:
            out += [float(line.split(",")[1])
                    for line in f.read().strip().splitlines()[1:]]
    return np.asarray(out)


def _seconds(fn, dev) -> float:
    """ms of one call of ``fn`` after one, synced."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0)


def collective_ms(exp, dev) -> dict:
    """ms of each collective of a step alone, at the step's shapes: the
    Megatron all_reduce of one encoder activation (B * L, d_model) fp32 over
    "model", a pipeline hop of one microbatch's activation in the compute
    dtype, and the all_reduce over "pipe" of the stage-replicated
    gradients."""
    mesh, cfg = exp.mesh, exp.model_cfg
    B, D = exp.batch_size, cfg.t5.d_model
    L = cfg.num_image_tokens + 32
    out = {}
    if mesh.n_model > 1:
        x = torch.zeros((B * L, D), device=dev)
        out["model_all_reduce_ms"] = _seconds(
            lambda: torch.distributed.all_reduce(x, group=mesh.model.group),
            dev)
    if mesh.n_pipe > 1:
        mb = B // (exp.microbatches or mesh.n_pipe)
        x = torch.zeros((mb, L, D), device=dev, dtype=torch.bfloat16)
        pair = 0 if mesh.stage == 0 else mesh.stage - 1
        out["hop_ms"] = _seconds(lambda: pmesh.pair_broadcast(
            x, mesh.pipe, pair, pair), dev)
        floats = sum(p.numel() for n, p in exp.params.named_parameters()
                     if exp.trainable[n] and pmesh.partial_axes(n, mesh)[0])
        g = torch.zeros(floats, device=dev)
        out["pipe_all_reduce_ms"] = _seconds(
            lambda: torch.distributed.all_reduce(g, group=mesh.pipe.group),
            dev)
    return out


def run_card_parallel(par_name: str, root: str, seed: int, dev) -> dict:
    """A card configuration of ``CARD_PARALLEL`` on the train load: under
    :func:`tp_decodes`, :func:`decode_ids` of the seeded weights (at fp32,
    with its K7 launches); per compared microbatch count, 3 fp32 steps
    at dropout 0 (the losses, the step-1 gradients by this rank's names,
    the trainable parameters after, gathered, and the kernel launches a
    step); then 2 + 10 timed bf16
    steps at dropout 0.1 and :func:`collective_ms`; then ``test()`` of the
    cli checkpoint at fp32 and at bf16 (its answers and the launches)."""
    par, _, impl, counts, tests = CARD_PARALLEL[par_name]
    res = {}
    exp = train_experiment(seed, dev, True, parallelism=par, impl=impl)
    batch = first_batch(exp)
    if tp_decodes(par):
        before = _build.launch_counts()["decode_attention_fused"]
        res["decode/ids"] = decode_ids(exp, batch, exp.mesh.model)
        res["decode/launches"] = np.asarray(
            _build.launch_counts()["decode_attention_fused"] - before)
    init = copy.deepcopy(exp.params)
    for M in counts:
        exp.microbatches = M
        exp.params = copy.deepcopy(init)
        exp.opt_state = adamw_init(exp.params)
        exp._train_step = None
        out = compared_steps(exp, batch, 0)
        tag = f"m{M}"
        res[f"{tag}/losses"] = out["losses"]
        res.update({f"{tag}/grad/{n}": v for n, v in out["grad"].items()})
        res.update({f"{tag}/launches/{k}": np.asarray(v)
                    for k, v in out["launches"].items()})
        dense = exp.dense_params()
        if exp.mesh.rank == 0:
            res.update({f"{tag}/params/{n}": v for n, v in _numpy(
                {n: p for n, p in dense.named_parameters()
                 if not n.startswith(("clip.", "clip_rn."))}).items()})
        res[f"{tag}/frozen_same"] = np.asarray(all(
            torch.equal(p, q) for (n, p), (_, q) in zip(
                dense.named_parameters(),
                pmesh.gather_params(init, exp.model_cfg, exp.mesh
                                    ).named_parameters())
            if n.startswith(("clip.", "clip_rn."))))
        del dense
    full = exp.dense_params() if counts else None
    del exp, init
    torch.cuda.empty_cache()
    exp = train_experiment(seed, dev, False, params=full, parallelism=par,
                           impl=impl)
    del full
    batch = first_batch(exp)
    res["ms"] = np.asarray(timed_ms(exp, batch))
    res.update({k: np.asarray(v) for k, v in collective_ms(exp, dev).items()})
    del exp, batch
    torch.cuda.empty_cache()
    if tests:
        res.update(card_test(root, dev, par))
    res.update({f"total/{k}": np.asarray(v)
                for k, v in _build.launch_counts().items()})
    return res


def card_test(root: str, dev, par=None,
              dtypes=("float32", "bfloat16")) -> dict:
    """``test()`` of the cli checkpoint (``{root}/cfg.json``) at each of
    ``dtypes`` under ``par``: the answers in test order (json), the
    overall accuracy and the kernel launches of each."""
    with open(os.path.join(root, "cfg.json")) as f:
        base = json.load(f)
    res = {}
    for dtype in dtypes:
        cfg = dict(base, compute_dtype=dtype)
        if par is not None:
            cfg["parallelism"] = par
        exp = TrainingExperiment(cfg, device=dev, train_mode=False,
                                 quiet=True,
                                 log_root=os.path.join(root, "mp_logs"),
                                 model_root=os.path.join(root, "models"))
        before = _build.launch_counts()
        t0 = time.perf_counter()
        metrics = exp.test()
        _sync(dev)
        res[f"test_{dtype}/s"] = np.asarray(time.perf_counter() - t0)
        res[f"test_{dtype}/answers"] = np.asarray(json.dumps(
            [str(a) for a in metrics.predictions.values()]))
        res[f"test_{dtype}/overall"] = np.asarray(metrics.overall)
        res.update({f"test_{dtype}/launches/{k}": np.asarray(v - before[k])
                    for k, v in _build.launch_counts().items()
                    if v != before[k]})
        del exp
    return res


# ---------------------------------------------------------------------------
# On the card: sequence parallelism and the data-sharded server
# ---------------------------------------------------------------------------

# the seq_parallel phase's mesh; the T5 encoder's heads and head width
CARD_SEQ = {"seq": 2}


def encode_reference(exp, dev) -> np.ndarray:
    """One process's ``t5_encode`` under "xla" of :func:`sp_encode_inputs`
    (B = 2, L = 4,096) on the experiment's fp32 T5."""
    cfg = dataclasses.replace(exp.model_cfg.t5, attention_impl="xla")
    embeds, mask = sp_encode_inputs(cfg.d_model)
    with torch.no_grad():
        out = t5_encode(exp.params.t5, cfg, torch.from_numpy(embeds).to(dev),
                        torch.from_numpy(mask).to(dev))
    return out.cpu().numpy()


def relu_gates(exp, batch, mesh=None) -> dict:
    """The ReLU gates (pre-activation > 0) of every T5 ``ff.wi`` in one fp32
    forward of the generative loss on ``batch`` without dropout, by the
    weight's name, (rows, positions, d_ff) bools packed along d_ff
    (``np.packbits``): with ``mesh`` the sequence-parallel forward (this
    rank's chunk of the encoder's positions, the decoder whole)."""
    cfg, t5 = exp.model_cfg, exp.params.t5
    seen, hooks = {}, []
    for stack in ("encoder", "decoder"):
        for i, p in enumerate(getattr(t5, stack).block):
            hooks.append(p.ff.wi.register_forward_hook(
                lambda mod, args, out, n=f"t5.{stack}.block.{i}.ff.wi.weight":
                seen.__setitem__(n, out > 0)))
    try:
        with torch.no_grad():
            if mesh is None:
                mprgen.loss_fn(exp.params, cfg, batch, compute=exp.params)
            else:
                psequence.sp_generative_loss(
                    exp.params, cfg, pmesh.shard_batch(batch, mesh), mesh,
                    torch.sum(batch["labels"] != -100), reduce=False)
    finally:
        for h in hooks:
            h.remove()
    B = batch["labels"].shape[0]
    return {n: np.packbits(g.reshape(B, -1, g.shape[-1]).cpu().numpy(),
                           axis=-1) for n, g in seen.items()}


@contextlib.contextmanager
def forced_gates(exp, gates: dict, record: bool = False):
    """Inside, every T5 ``ff.wi`` forward takes its ReLU gates from
    ``gates`` (by weight name, bools of the shape :func:`relu_gates`
    unpacks to, or a list of them that the forwards of that weight take in
    call order: a remat recompute calls each layer again): where the
    forward's own gate differs, the pre-activation is negated, its gradient
    kept, so that the ReLU passes or stops the cotangent as ``gates`` say.
    Yields {name: [gates set apart, gates the forced value still leaves
    apart (an exact 0)]}, filled as the forwards run. With ``record``, the
    forwards are left as they are and append their own gates, on the CPU,
    to the lists of ``gates``."""
    t5 = exp.params.t5
    seen, hooks = {}, []

    def force(out, n):
        if record:
            gates.setdefault(n, []).append((out > 0).cpu())
            return out
        want = gates[n].pop(0) if isinstance(gates[n], list) else gates[n]
        want = want.to(out.device).reshape(out.shape)
        flip = (out > 0) != want
        out = out - 2 * (out * flip).detach()
        counts = seen.setdefault(n, [0, 0])
        counts[0] += int(flip.sum())
        counts[1] += int(((out > 0) != want).sum())
        return out

    for stack in ("encoder", "decoder"):
        for i, p in enumerate(getattr(t5, stack).block):
            hooks.append(p.ff.wi.register_forward_hook(
                lambda mod, args, out, n=f"t5.{stack}.block.{i}.ff.wi.weight":
                force(out, n)))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def run_card_sp(root: str, seed: int, dev) -> dict:
    """The seq_parallel phase's ranks on the train load under
    :data:`CARD_SEQ`: ``sp_t5_encode`` of :func:`sp_encode_inputs` on the
    seeded fp32 T5 (rank 0 keeps it, with its seconds); 3 fp32 steps at
    dropout 0 (the losses, the step-1 gradients, the kernel launches a
    step, the trainable parameters after on rank 0, the frozen ones
    unchanged) and, first, the :func:`relu_gates` of the SP forward; 2 +
    10 timed bf16 steps at dropout 0.1; a ring hop of one layer's K, V and
    key mask and the gradient ``all_reduce``, each alone; ``test()`` of the
    cli checkpoint at fp32; the whole run's launches."""
    res = {}
    exp = train_experiment(seed, dev, True, parallelism=CARD_SEQ)
    mesh, cfg = exp.mesh, exp.model_cfg
    embeds, mask = sp_encode_inputs(cfg.t5.d_model)
    embeds, mask = (torch.from_numpy(x).to(dev) for x in (embeds, mask))
    t0 = time.perf_counter()
    out = psequence.sp_t5_encode(exp.params.t5, cfg.t5, embeds, mask, mesh)
    _sync(dev)
    res["encode_s"] = np.asarray(time.perf_counter() - t0)
    if mesh.rank == 0:
        res["encode"] = out.cpu().numpy()
    del out, embeds, mask
    batch = first_batch(exp)
    res.update({f"gates/{n}": g for n, g in relu_gates(exp, batch,
                                                        mesh).items()})
    frozen = {n: p.detach().clone() for n, p in exp.params.named_parameters()
              if not exp.trainable[n]}
    out = compared_steps(exp, batch, 0)
    res["losses"] = out["losses"]
    res.update({f"grad/{n}": v for n, v in out["grad"].items()})
    res.update({f"launches/{k}": np.asarray(v)
                for k, v in out["launches"].items()})
    if mesh.rank == 0:
        res.update({f"params/{n}": v for n, v in out["params"].items()
                    if exp.trainable[n]})
    res["frozen_same"] = np.asarray(all(
        torch.equal(p, frozen[n]) for n, p in exp.params.named_parameters()
        if n in frozen))
    del frozen, out
    exp = train_experiment(seed, dev, False, params=exp.params,
                           parallelism=CARD_SEQ)
    res["ms"] = np.asarray(timed_ms(exp, first_batch(exp)))
    H, Dh = cfg.t5.num_heads, cfg.t5.d_kv
    L = cfg.num_image_tokens + 32
    Lc = L // mesh.n_seq
    kv = torch.zeros(2 * exp.batch_size * H * Lc * Dh
                     + exp.batch_size * Lc, dtype=torch.bfloat16, device=dev)
    res["hop_ms"] = np.asarray(_seconds(
        lambda: psequence.ring_hop(kv, mesh.seq), dev))
    floats = sum(p.numel() for n, p in exp.params.named_parameters()
                 if exp.trainable[n])
    grads = torch.zeros(floats, device=dev)
    res["grad_all_reduce_ms"] = np.asarray(_seconds(
        lambda: torch.distributed.all_reduce(
            grads, group=mesh.batch_axes.group), dev))
    del exp, kv, grads
    torch.cuda.empty_cache()
    res.update(card_test(root, dev, CARD_SEQ, dtypes=("float32",)))
    res.update({f"total/{k}": np.asarray(v)
                for k, v in _build.launch_counts().items()})
    return res


def serve_window(server, tests, images):
    """The serve window of ``chip_smoke.py``'s serving paths: the images
    staged, then two submits (2 chunks, then the rest), the second queued
    behind the first; returns the answers."""
    names = [e["image_name"] for e in tests]
    unique = list(dict.fromkeys(names))
    server.stage_images(np.stack([images[n] for n in unique]), unique)
    B = server.exp.batch_size
    handles = [server.submit(None, [e["question"] for e in tests[part]],
                             [e["task"] for e in tests[part]],
                             image_ids=names[part])
               for part in (slice(0, 2 * B), slice(2 * B, len(tests)))]
    return [a for h in handles for a in h.result()]


class RowServer(MPRServer):
    """A server that keeps, in chunk order, each chunk's rows on this
    process (``rows``: the leading dimension of the step's output before
    the data indices' blocks are gathered) and its greedy ids (``ids``, as
    the dispatcher thread fetched them, gathered), and the rows of this
    process's block of each staged table (``table_rows``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.ids, self.rows, self.table_rows = [], [], []

    def _gather_rows(self, ids, k):
        self.rows.append(int(ids.shape[0]))
        return super()._gather_rows(ids, k)

    def _gather_table(self, t, n):
        self.table_rows.append(int(t.shape[0]))
        return super()._gather_table(t, n)

    def _run_chunk(self, run):
        ids = super()._run_chunk(run)
        self.ids.append(ids)
        return ids


def small_entries(tests):
    """8 requests of one question text on 8 different images: every row
    block of 4 has the prompt widths of the whole (the T5 bucket, the CLIP
    text's), so one process at B = 4 runs the blocks a rank runs at B =
    8."""
    first = tests[0]["question"]
    return [e for e in tests if e["question"] == first][:8]


def small_ids(exp, tests, images, batch_size: int):
    """The greedy ids of :func:`small_entries` at fp32, served in chunks of
    ``batch_size``, and each chunk's rows on this process."""
    small = copy.copy(exp)
    small.model_cfg = dataclasses.replace(exp.model_cfg,
                                          compute_dtype="float32")
    small.batch_size = batch_size
    server = RowServer(small, load_checkpoint=False)
    entries = small_entries(tests)
    names = [e["image_name"] for e in entries]
    server.answer(np.stack([images[n] for n in names]),
                  [e["question"] for e in entries],
                  [e["task"] for e in entries], image_ids=names)
    return np.concatenate(server.ids), server.rows


def serve_run(exp, tests, images, dev, small_batch: int) -> dict:
    """The sharded_serve load of one process or rank: a warm-up window,
    then the timed window (its seconds, answers, kernel launches, counted
    from 0 around it, and the rows each chunk and staged table ran here),
    and :func:`small_ids` at ``small_batch`` with its chunks' rows."""
    server = RowServer(exp, load_checkpoint=False)
    serve_window(server, tests, images)  # warm-up: every width, the heuristics
    server.chunks = {"fused": 0, "host": 0}
    server.rows, server.table_rows = [], []
    _sync(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    answers = serve_window(server, tests, images)
    _sync(dev)
    res = {"window_s": np.asarray(time.perf_counter() - t0),
           "answers": np.asarray(json.dumps(answers)),
           "chunks": np.asarray(json.dumps(server.chunks)),
           "rows": np.asarray(server.rows),
           "table_rows": np.asarray(server.table_rows)}
    res.update({f"launches/{k}": np.asarray(v)
                for k, v in _build.launch_counts().items()})
    res["small_ids"], rows = small_ids(exp, tests, images, small_batch)
    res["small_rows"] = np.asarray(rows)
    return res


def run_card_serve(seed: int, dev) -> dict:
    """The sharded_serve phase's ranks: the main serving load under
    ``{"data": 2}`` (:func:`serve_run`, the small input at B = 8, 4 rows a
    rank), then, each alone at its shapes, the staging gather of a rank's
    blocks of the two tables and a chunk's token gather."""
    from multimodalpromptretrieval_tpu_torch.serving import north_star_setup

    exp, tests, images = north_star_setup(
        seed, dev, path="main", config={"parallelism": {"data": 2}})
    res = serve_run(exp, tests, images, dev, 8)
    mesh, cfg = exp.mesh, exp.model_cfg
    block = len({e["image_name"] for e in tests}) // mesh.n_data
    dt = mprgen.compute_dtype(cfg)
    emb = torch.zeros((block, cfg.clip.embed_dim), dtype=dt, device=dev)
    pref = torch.zeros((block, cfg.num_image_tokens, cfg.t5.d_model),
                       dtype=dt, device=dev)
    res["stage_gather_ms"] = np.asarray(_seconds(
        lambda: [pmesh.gather_bits(t, mesh) for t in (emb, pref)], dev))
    ids = torch.zeros((exp.batch_size // mesh.n_data, 21), dtype=torch.int32,
                      device=dev)
    res["token_gather_ms"] = np.asarray(_seconds(
        lambda: pmesh.gather_rows(ids, mesh), dev))
    return res

# ---------------------------------------------------------------------------
# Sequence parallelism and the data-sharded server
# ---------------------------------------------------------------------------

# the ring attention cases: the plain softmax, T5's (scale 1, a position
# bias, a key mask with a fully masked row) and the causal one
SP_CASES = ("plain", "t5", "causal")


def sp_attention_inputs() -> dict:
    """q, k, v (4, 4, 16, 8), a (1, 4, 16, 16) bias and a (4, 16) key mask
    whose row 0 is fully masked, from a numpy seed."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(4, 4, 16, 8)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(1, 4, 16, 16)).astype(np.float32)
    mask = rng.random((4, 16)) > 0.3
    mask[0] = False
    return dict(q=q, k=k, v=v, bias=bias, mask=mask)


def sp_case(case: str, inputs: dict):
    """(the attention's keywords, the call's keywords) of a ring case."""
    if case == "t5":
        return dict(scale=1.0), dict(bias=inputs["bias"],
                                     kv_mask=inputs["mask"])
    if case == "causal":
        return dict(causal=True), {}
    return {}, {}


def sp_encode_inputs(d_model: int, length: int = 4096):
    """(embeds (2, length, d_model), mask (2, length)) from a numpy seed:
    row 1's last 2,100 positions padded, over the middle of the sequence
    (the chunk boundary of two seq ranks)."""
    rng = np.random.default_rng(9)
    embeds = rng.normal(size=(2, length, d_model)).astype(np.float32)
    mask = np.ones((2, length), np.int32)
    mask[1, -2100:] = 0
    return embeds, mask


def ring_cases(mesh) -> dict:
    """Each :data:`SP_CASES` case: ``make_sp_attention``'s global output,
    and the global gradients of q, k and v of the sum over the ranks of
    their outputs' squares (each rank's chunk a leaf, the ring's backward
    carrying dk, dv home)."""
    inputs = {k: torch.from_numpy(v) for k, v in
              sp_attention_inputs().items()}
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    b, Lc = q.shape[0] // mesh.n_data, q.shape[2] // mesh.n_seq
    rows = slice(mesh.index * b, (mesh.index + 1) * b)
    chunk = slice(mesh.seq_index * Lc, (mesh.seq_index + 1) * Lc)
    res = {}
    for case in SP_CASES:
        make_kw, call_kw = sp_case(case, inputs)
        res[f"attn/{case}"] = psequence.make_sp_attention(mesh, **make_kw)(
            q, k, v, **call_kw).numpy()
        leaves = [x[rows, :, chunk].clone().requires_grad_()
                  for x in (q, k, v)]
        mask = call_kw.get("kv_mask")
        out = psequence.ring_attention(
            *leaves, axis=mesh.seq, bias=call_kw.get("bias"),
            kv_mask=None if mask is None else mask[rows, chunk], **make_kw)
        torch.sum(out ** 2).backward()
        with torch.no_grad():
            for name, x in zip("qkv", leaves):
                res[f"grad/{case}/{name}"] = psequence.gather_global(
                    x.grad, mesh, dim=2).numpy()
    return res


def run_sequence(root: str, seed: int = 0) -> dict:
    """The "sp" load on the inputs the test wrote (``{root}/mp_inputs.pt``:
    the JAX init of ``tests/test_sequence.py``'s configuration and its
    batch of 16, L = 17 over seq 2): :func:`ring_cases`;
    ``sp_t5_encode`` at L = 4,096 (:func:`sp_encode_inputs`); the eval
    loss; three SP steps at dropout 0 (the losses, the parameters after
    the first, the step-1 gradients as AdamW receives them, and one
    process's losses and gradients); three steps at dropout 0.1 beside one
    process's with the same generator."""
    data = torch.load(os.path.join(root, "mp_inputs.pt"))
    batch = data["batch"]
    cfg = tiny_model_cfg(MODEL_PARALLEL["sp"][2])
    full = mprgen.MPRGen(cfg)
    full.load_state_dict(data["state"])
    mesh = pmesh.build_mesh({"parallelism": MODEL_PARALLEL["sp"][0],
                             "hyperparameters": {
                                 "batch_size": len(batch["labels"])}})
    res = ring_cases(mesh)
    embeds, mask = sp_encode_inputs(cfg.t5.d_model)
    res["encode"] = psequence.sp_t5_encode(
        full.t5, cfg.t5, torch.from_numpy(embeds), torch.from_numpy(mask),
        mesh).numpy()
    res["eval/loss"] = np.asarray(float(
        steps.make_eval_loss_step(cfg, mesh=mesh)(full, batch)))
    local = copy.deepcopy(full)
    step = steps.make_train_step(cfg, mprgen.trainable_mask(local, cfg),
                                 mesh=mesh)
    opt = adamw_init(local)
    with first_grads() as seen:
        losses = [float(step(local, opt, batch, 1e-3, None))]
        res.update({f"step1/{n}": v.copy() for n, v in _numpy(
            dict(local.named_parameters())).items()})
        losses += [float(step(local, opt, batch, 1e-3, None))
                   for _ in range(STEPS - 1)]
    res["steps/losses"] = np.asarray(losses)
    res.update({f"sgrad/{n}": v for n, v in _numpy(seen[0]).items()})
    res["steps/ref"], want = model_steps(cfg, copy.deepcopy(full), batch,
                                         None, STEPS)
    res.update({f"sgradref/{n}": v for n, v in _numpy(want).items()})
    dcfg = tiny_model_cfg(MODEL_PARALLEL["sp"][2], 0.1)
    for tag, m in (("drop/ref", None), ("drop/losses", mesh)):
        res[tag], _ = model_steps(dcfg, copy.deepcopy(full), batch, m,
                                  STEPS, torch.Generator().manual_seed(seed))
    return res


# the data-sharded server's configurations (``cfg_{name}.json`` and the
# bridged JAX init ``state_{name}.pt`` under the root) and their server
# options; the request counts, odd, below and above the chunk of 4
SERVE_CASES = {
    "k1": (("fused", {}), ("host", {"prompt_fastpath": False}),
           ("spec", {"spec_decode": 4}), ("sort", {"length_sort": True})),
    "k3": (("fused", {}), ("host", {"prompt_fastpath": False})),
    "head": (("plain", {}),),
}
SERVE_SIZES = (3, 9)


def serve_requests(entries, images, n: int = 9):
    """(images, questions, tasks, image ids) of the first ``n`` of the test
    split twice over."""
    entries = (list(entries) * 2)[:n]
    return (np.stack([images[e["image_name"]] for e in entries]),
            [e["question"] for e in entries], [e["task"] for e in entries],
            [e["image_name"] for e in entries])


def serve_stream_text(entries) -> str:
    """The JSONL stream of the serve load: the 9 requests by image name,
    a malformed one fourth."""
    lines = [json.dumps({"question": e["question"], "task": e["task"],
                         "image_name": e["image_name"]})
             for e in (list(entries) * 2)[:9]]
    lines.insert(3, json.dumps({"question": "", "image_name": "x"}))
    return "\n".join(lines) + "\n"


def serve_experiment(root: str, name: str, parallelism: bool = True):
    """The port's experiment of configuration ``name`` on the disk data,
    with the bridged JAX init (``state_{name}.pt``); without
    ``parallelism``, for one process."""
    with open(os.path.join(root, f"cfg_{name}.json")) as f:
        cfg = json.load(f)
    if not parallelism:
        cfg.pop("parallelism")
    probe = ServingExperiment(dict(cfg, retrieval=0), device="cpu")
    params = mprgen.MPRGen(probe.model_cfg)
    params.load_state_dict(torch.load(os.path.join(root,
                                                   f"state_{name}.pt")))
    return ServingExperiment(cfg, params=params, device="cpu",
                             model_root=os.path.join(root, "no_models"))


def serve_answers(exp, name: str) -> dict:
    """The answers of configuration ``name``'s cases (json strings by
    ``{name}/{case}/{n}``), with the chunks each server ran; for "k1" also
    two pipelined submits over staged images, and for "k3"
    ``cli.serve_stream`` of :func:`serve_stream_text`."""
    images, questions, tasks, ids = serve_requests(exp.splits["test"],
                                                   exp.images)
    res = {}
    for case, kw in SERVE_CASES[name]:
        server = RowServer(exp, load_checkpoint=False, **kw)
        for n in SERVE_SIZES:
            res[f"{name}/{case}/{n}"] = json.dumps(server.answer(
                images[:n], questions[:n], tasks[:n], image_ids=ids[:n]))
        res[f"{name}/{case}/chunks"] = json.dumps(server.chunks)
        res[f"{name}/{case}/rows"] = json.dumps(server.rows)
    if name == "k1":
        server = RowServer(exp, load_checkpoint=False)
        server.stage_images(images, ids)
        first = server.submit(None, questions, tasks, image_ids=ids)
        second = server.submit(None, questions[::-1], tasks[::-1],
                               image_ids=ids[::-1])
        res["k1/staged"] = json.dumps(first.result() + second.result())
        res["k1/staged/rows"] = json.dumps(server.rows)
        res["k1/staged/table_rows"] = json.dumps(server.table_rows)
        res["k1/staged/unique"] = str(len(set(ids)))
    if name == "k3":
        out = io.StringIO()
        cli.serve_stream(exp, io.StringIO(serve_stream_text(
            exp.splits["test"])), out)
        res["k3/stream"] = out.getvalue()
    return res


def run_serve(root: str) -> dict:
    """The "serve" load: :func:`serve_answers` of every configuration
    under its ``{"data": 2}``."""
    res = {}
    for name in SERVE_CASES:
        res.update(serve_answers(serve_experiment(root, name), name))
    return {k: np.asarray(v) for k, v in res.items()}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", choices=LOADS, default="tiny")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", required=True,
                   help="a port; the model-parallel loads take three, "
                   "comma-separated (the steps' group, the cli's two)")
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--par", choices=tuple(CARD_PARALLEL) + ("sp", "serve"),
                   help="the train load's model-parallel configuration, "
                   "sequence parallelism or the data-sharded server")
    args = p.parse_args()
    ports = [int(x) for x in args.port.split(",")]
    if args.load != "train":
        torch.set_num_threads(1)
        dev = "cpu"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = None
    multihost.initialize(f"localhost:{ports[0]}", args.world, args.rank,
                         device=dev)
    tag = args.par or (args.load if args.load not in ("tiny", "train")
                       else "")
    name = f"{tag}_rank{args.rank}" if tag else f"rank{args.rank}"
    try:
        dev = dev or torch.device("cuda", multihost.local_device_index())
        if args.load == "sp":
            res = run_sequence(args.root, args.seed)
        elif args.load == "serve":
            res = run_serve(args.root)
        elif args.load in MODEL_PARALLEL:
            res = run_model_parallel(args.load, args.root, args.seed)
        elif args.par == "sp":
            res = run_card_sp(args.root, args.seed, dev)
        elif args.par == "serve":
            res = run_card_serve(args.seed, dev)
        elif args.par:
            res = run_card_parallel(args.par, args.root, args.seed, dev)
        else:
            res = run(args.load, os.path.join(args.root, f"rank{args.rank}"),
                      os.path.join(args.root, "models"), inputs=args.root,
                      seed=args.seed, dev=dev)
        np.savez(os.path.join(args.root, f"{name}.npz"), **res)
    finally:
        multihost.shutdown()
    if args.load in MODEL_PARALLEL:
        cli_runs(args.load, args.root, args.rank, args.world, ports)


if __name__ == "__main__":
    main()
