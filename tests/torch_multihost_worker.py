"""The port's data-parallel check: one process of a group, or the same work
in one process to compare with.

    python tests/torch_multihost_worker.py --load tiny|train --rank R \\
        --world W --port P --root DIR [--seed S]

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodalpromptretrieval_tpu_torch.models import mprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import _build  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.layers import BatchShard  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import (  # noqa: E402
    mesh as pmesh,
    multihost,
    retrieval as pretrieval,
)
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    SERVE_PATHS,
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import step as steps  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
    north_star_train_setup,
)

LOADS = ("tiny", "train")
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


def train_experiment(seed: int, dev, fp32: bool,
                     params=None) -> TrainingExperiment:
    """The train load (bf16 compute, dropout 0.1), or with ``fp32`` at fp32
    and dropout 0."""
    config = None
    if fp32:
        config = {"compute_dtype": "float32", "t5_overrides": dict(
            SERVE_PATHS["main"]["t5_overrides"], dropout_rate=0.0)}
    return north_star_train_setup(seed, dev, params=params, config=config,
                                  quiet=True)


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
        local = pmesh.shard_batch(batch, pmesh.DataMesh(blocks, index=r))
        loss = (mprgen.loss_fn(exp.params, cfg, local,
                               BatchShard(gen, r, blocks),
                               compute=exp.params)
                * pmesh.loss_weight(cfg, batch, local))
        for n, g in steps.backward(loss, exp.params).items():
            if g is not None:
                total[n] = total.get(n, 0) + g.detach().float()
    gen.set_state(state)
    return {n: g.cpu().numpy() for n, g in total.items()}


def compared_steps(exp, batch, blocks: int) -> dict:
    """Losses of STEPS steps, every parameter after, the step-1
    gradients as AdamW receives them, the kernel launches a step, and with
    ``blocks`` :func:`block_grads`."""
    out = {}
    if blocks:
        out["blocks"] = block_grads(exp, batch, blocks)
    seen = []
    update = steps.adamw_update

    def capture(params, grads, *a, **kw):
        if not seen:
            seen.append({n: g.detach().float().cpu().numpy().copy()
                         for n, g in grads.items() if g is not None})
        return update(params, grads, *a, **kw)

    step = exp.train_step()
    lr = exp.cfg["hyperparameters"]["learning_rate"]
    before = _build.launch_counts()
    steps.adamw_update = capture
    try:
        losses = [float(step(exp.params, exp.opt_state, batch, lr,
                             exp.dropout_gen)) for _ in range(STEPS)]
    finally:
        steps.adamw_update = update
    after = _build.launch_counts()
    out.update(losses=np.asarray(losses), params=_params(exp),
               grad=seen[0], launches={k: (after[k] - before[k]) // STEPS
                                       for k in after
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
    mesh = pmesh.DataMesh(multihost.process_count())
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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--load", choices=LOADS, default="tiny")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if args.load == "tiny":
        torch.set_num_threads(1)
        dev = "cpu"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = None
    multihost.initialize(f"localhost:{args.port}", args.world, args.rank,
                         device=dev)
    try:
        dev = dev or torch.device("cuda", multihost.local_device_index())
        res = run(args.load, os.path.join(args.root, f"rank{args.rank}"),
                  os.path.join(args.root, "models"), inputs=args.root,
                  seed=args.seed, dev=dev)
        np.savez(os.path.join(args.root, f"rank{args.rank}.npz"), **res)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
