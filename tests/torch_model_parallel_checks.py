"""Checks shared by the tensor- and pipeline-parallel tests: the JAX
tests' tiny configuration and batch, the workers' inputs, one process's cli
runs, the shard table against the JAX specs, and the cli runs of a load
against one process's. Imports the JAX package: only tests use it."""

import json
import os

import jax
import numpy as np
import torch

from multimodalpromptretrieval_tpu.models import mprgen as jmprgen
from multimodalpromptretrieval_tpu.models.clip import CLIPConfig as JCLIP
from multimodalpromptretrieval_tpu.models.t5 import T5Config as JT5
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh
from multimodalpromptretrieval_tpu.parallel import pipeline as jpipe
from multimodalpromptretrieval_tpu_torch import bridge
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
from multimodalpromptretrieval_tpu_torch.train.experiment import (
    TrainingExperiment,
    run_from_config,
)

import torch_multihost_worker as worker

def jax_tiny_cfg(layers: int):
    """The JAX tests' tiny configuration (``tests/test_parallel.py``: 2
    layers; ``tests/test_pipeline.py``: 4)."""
    return jmprgen.MPRGenConfig(
        t5=JT5(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
               num_layers=layers, num_decoder_layers=layers, num_heads=4),
        clip=JCLIP(embed_dim=32, image_resolution=32, vision_width=32,
                   vision_layers=1, patch_size=16, context_length=8,
                   vocab_size=64, text_width=32, vision_heads_override=2,
                   text_heads_override=2),
        use_image_info=True)


def jax_batch(B: int = 16):
    """The JAX tests' batch: 2 of 6 label slots ignored."""
    rng = np.random.default_rng(0)
    labels = rng.integers(2, 256, size=(B, 6)).astype(np.int64)
    labels[:, -2:] = -100
    return {"images": rng.normal(size=(B, 3, 32, 32)).astype(np.float32),
            "input_ids": rng.integers(2, 256, size=(B, 12)).astype(np.int32),
            "text_mask": np.ones((B, 12), np.int32), "labels": labels}


def write_inputs(root: str, layers: int):
    """The JAX init (PRNGKey 0) and batch for the workers
    (``{root}/mp_inputs.pt``); returns (JAX params, batch, config)."""
    cfg = jax_tiny_cfg(layers)
    params = jmprgen.init_mprgen(jax.random.PRNGKey(0), cfg)
    batch = jax_batch()
    model = bridge.params_from_jax(params, worker.tiny_model_cfg(layers))
    torch.save({"state": model.state_dict(),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               os.path.join(root, "mp_inputs.pt"))
    return params, batch, cfg


def port_tree(tree, layers: int):
    """A JAX tree as numpy arrays by the port's parameter names."""
    return {n: t.numpy() for n, t in bridge.tensors_from_jax(
        tree, worker.tiny_model_cfg(layers)).items()}


def one_process_cli(root: str):
    """One process's ``run_from_config`` train + test, then resume + test,
    on ``{root}/cfg.json`` (logs under ``{root}/one``)."""
    cfg_path = os.path.join(root, "cfg.json")
    one = os.path.join(root, "one")
    out = {}
    for tag, kw in (("first", dict(train=True)), ("resume", dict(
            resume=True))):
        exp, res = run_from_config(
            cfg_path, test=True, device="cpu", quiet=True,
            log_root=os.path.join(one, f"logs_{tag}"),
            model_root=os.path.join(one, "models"), **kw)
        out[tag] = res["test"]
    return out


def load_ranks(root: str, load: str):
    """Each rank's results of a model-parallel load."""
    return [dict(np.load(os.path.join(root, f"{load}_rank{r}.npz")))
            for r in range(worker.MODEL_PARALLEL[load][1])]


def _jax_specs(spec_fn, params):
    """JAX PartitionSpec of every leaf by its key path."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            spec_fn(path, leaf) for path, leaf in flat}


def _port_as_jax(leaf, spec):
    """The port's (split over pipe, kind) of a leaf as the JAX spec of the
    JAX leaf behind it: block leaves stacked over layers first, dense
    kernels (in, out)."""
    P = jax.sharding.PartitionSpec
    pipe, kind = spec
    if leaf.layer is None:
        return P(None, "model") if kind == "heads" else P()
    first = "pipe" if pipe else None
    if kind in ("qkv", "out"):
        return P(first, None, "model")
    if kind == "in":
        return P(first, "model", None)
    return P("pipe") if pipe else P()


def check_shard_table(n_pipe: int, n_model: int, layers: int):
    """Every leaf of ``bridge.name_map``: the port's spec is the JAX spec of
    its JAX leaf (``_spec_for_path`` for TP, ``_pp_tp_spec`` under
    "pipe"), and every JAX leaf is met."""
    params = jmprgen.init_mprgen(jax.random.PRNGKey(0), jax_tiny_cfg(layers))
    if n_pipe > 1:
        specs = _jax_specs(lambda p, x: jpipe._pp_tp_spec(p, x, n_model),
                           params)
    else:
        specs = _jax_specs(jmesh._spec_for_path, params)
    seen = set()
    for leaf in bridge.name_map(worker.tiny_model_cfg(layers)):
        spec = pmesh.param_spec(leaf.name, n_pipe, n_model)
        assert _port_as_jax(leaf, spec) == specs[leaf.path], leaf.name
        seen.add(leaf.path)
    assert seen == set(specs)


def check_cli_runs(root: str, load: str, one: dict):
    """The load's ``cli.py --train --test`` and ``--resume --test`` against
    one process's: the losses within ``rtol=2e-3``, the same test()
    performance file and 24 answers; the checkpoint loads in one process
    and answers as the parallel test() did."""
    work = os.path.join(root, load)
    for logs, mine in (("logs_first", "logs_first"), ("logs", "logs_resume")):
        np.testing.assert_allclose(
            worker.read_losses(os.path.join(work, logs)),
            worker.read_losses(os.path.join(root, "one", mine)), rtol=2e-3)
    (perf,) = [f for f in os.listdir(os.path.join(work, "logs"))
               if f.endswith("performance.txt")]
    for logs, mine in (("logs_first", "logs_first"), ("logs", "logs_resume")):
        with open(os.path.join(work, logs, perf)) as a, open(
                os.path.join(root, "one", mine, perf)) as b:
            assert a.read() == b.read()
        with open(os.path.join(work, logs, "correct_ids.txt")) as a, open(
                os.path.join(work, logs, "incorrect_ids.txt")) as b:
            assert len(a.read().split()) + len(b.read().split()) == 24
    (ckpt,) = [f for f in os.listdir(os.path.join(work, "models"))
               if f.endswith(".npz")]
    with open(os.path.join(root, "cfg.json")) as f:
        cfg = json.load(f)
    exp = TrainingExperiment(cfg, device="cpu", train_mode=False, quiet=True,
                             model_file=os.path.join(work, "models", ckpt),
                             log_root=os.path.join(work, "one_process"))
    metrics = exp.test()
    assert sum(metrics.total.values()) == 24
    assert metrics.predictions == one["resume"].predictions
