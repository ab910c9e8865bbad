"""The port's pipeline parallelism (GPipe over "pipe") and its composition
with tensor parallelism (TP x PP) against the JAX package and one process,
on the CPU.

In-process: the shard table matches the JAX ``_pp_tp_spec`` leaf by leaf
under "pipe" and "pipe" x "model"; the pipelined experiment and step refuse
what the JAX ones refuse, with their messages; each stage's dropout masks
are one process's draws of its sites, in order; the flash kernel's
backward (the recompute the card runs, ``ops/attention._flash_bwd``)
matches autograd through its plain version.

Gloo processes (``tests/torch_multihost_worker.py``): "pp" (2 stages) and
"tp_pp" (2 stages x 2 model ranks) on the JAX ``tests/test_pipeline.py``
tiny configuration (4 + 4 layers), against the JAX PP and TP x PP steps on
the virtual CPU devices from the same init and batch: the loss within 1e-5
relative and the parameters after one AdamW step within the JAX test's
bounds (rtol 1e-3, atol 5e-4); against one process: each rank's gradients
whole, the eval loss over 4 microbatches, three steps at dropout 0.1
within 1e-5 with the leaves that ranks share bit-equal, and the cli runs
(``--train --test`` then ``--resume --test``) within ``rtol=2e-3`` of one
process's losses with the same answers, the checkpoint loading in one
process.
"""

import copy
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import pipeline as jpipe  # noqa: E402
from multimodalpromptretrieval_tpu.train import experiment as jexperiment  # noqa: E402
from multimodalpromptretrieval_tpu.train.optim import (  # noqa: E402
    adamw_init as jadamw_init,
)
from multimodalpromptretrieval_tpu_torch.ops import attention as pattention  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.layers import BatchShard  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import multihost  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)

import torch_multihost_worker as worker  # noqa: E402
from torch_model_parallel_checks import (  # noqa: E402
    check_cli_runs,
    check_shard_table,
    jax_tiny_cfg,
    load_ranks,
    one_process_cli,
    port_tree,
    write_inputs,
)

LOADS = ("pp", "tp_pp")
SPAWN_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The "pp" and "tp_pp" loads, their processes all started at once;
    meanwhile, here, the JAX PP and TP x PP steps and one process's cli
    runs (one config, and one process, for both)."""
    root = str(tmp_path_factory.mktemp("torch_pp"))
    params, batch, cfg = write_inputs(root, 4)
    worker.write_cli_inputs(root, LOADS)
    procs = []
    for load in LOADS:
        procs += worker.spawn(load, root, worker.MODEL_PARALLEL[load][1])
    try:
        trainable = jmprgen.trainable_mask(params, cfg)
        jax_res = {}
        for load, n_model in (("pp", 1), ("tp_pp", 2)):
            mesh = jpipe.get_pipe_mesh(n_data=1, n_pipe=2, n_model=n_model)
            specs = jpipe.param_pipe_specs(params, n_model=n_model)
            step = jpipe.make_train_step_pp(cfg, trainable, mesh=mesh,
                                            param_specs=specs, donate=False)
            p2, _, loss = step(jpipe.shard_params_pp(params, mesh),
                               jpipe.shard_params_pp(jadamw_init(params),
                                                     mesh),
                               jmesh.shard_batch(batch, mesh),
                               jnp.float32(1e-3), None)
            jax_res[load] = {"loss": float(loss),
                             "params": port_tree(p2, 4)}
        one = one_process_cli(root)
    finally:
        fail = worker.finish(procs, SPAWN_TIMEOUT)
    assert not fail, "\n".join(fail)
    return {"root": root, "jax": jax_res, "one": one,
            "ranks": {load: load_ranks(root, load)
                      for load in LOADS}}


# ---------------------------------------------------------------------------
# In-process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_model", [1, 2])
def test_shard_table_matches_jax_pp_tp_spec(n_model):
    """Under "pipe" (x "model"): the blocks' leaves over "pipe", their
    kernels also by the Megatron rules, the ``rel_bias`` tables over their
    heads with "model", the rest replicated: the JAX ``_pp_tp_spec``."""
    check_shard_table(2, n_model, 4)


def test_pipelined_experiment_refuses_as_in_jax(monkeypatch):
    """``parallelism.pipe > 1`` with the head / BAN variants or
    ``exact_train_predict``: the JAX ``_check_pp_config`` message."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    splits, images = synthetic_slake(2, 1, image_size=32, n_validate=1)
    base = synthetic_config(batch_size=8, image_size=32)
    base["clip_overrides"]["patch_size"] = 16
    base["parallelism"] = {"pipe": 2}
    for keys in ({"use_prediction_head": 1},
                 {"use_prediction_head": 1, "use_BAN": 1},
                 {"exact_train_predict": 1},
                 {"use_prediction_head": 1, "exact_train_predict": 1}):
        cfg = dict(copy.deepcopy(base), **keys)
        with pytest.raises(ValueError) as want:
            jexperiment.Experiment._check_pp_config(None, cfg)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            TrainingExperiment(cfg, train=splits["train"],
                               validate=splits["validate"], images=images,
                               device="cpu", quiet=True)


@pytest.mark.parametrize("layers,heads,d_ff,n_model", [
    (3, 4, 64, 1), (4, 3, 64, 2), (4, 4, 66, 4)])
def test_pipelined_step_refuses_as_in_jax(layers, heads, d_ff, n_model):
    """Layers that do not split into the stages, heads or ``d_ff`` that do
    not split over "model": the JAX ``make_train_step_pp`` messages."""
    import dataclasses

    jcfg = jax_tiny_cfg(layers)
    jcfg = dataclasses.replace(jcfg, t5=dataclasses.replace(
        jcfg.t5, num_heads=heads, d_ff=d_ff))
    with pytest.raises(AssertionError) as want:
        jpipe.make_train_step_pp(jcfg, mesh=jpipe.get_pipe_mesh(
            n_data=1, n_pipe=2, n_model=n_model), param_specs={})
    cfg = worker.tiny_model_cfg(layers)
    cfg = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, num_heads=heads, d_ff=d_ff))
    mesh = pmesh.Mesh(1, 2, n_model)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ppipe.make_train_step_pp(cfg, mesh=mesh)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ppipe.make_eval_loss_step_pp(cfg, mesh=mesh)


@pytest.mark.parametrize("n_pipe", [2, 4])
def test_stage_masks_are_one_process_draws(n_pipe):
    """Each stage's masks, from the same generator state, are one
    process's draws of the sites it holds, in one process's order: the
    stacks' layers split over the stages, the encoder output's mask on
    every stage, the inputs' on stage 0, the head's on the last."""
    cfg = worker.tiny_model_cfg(4, 0.1)
    B, L, T = 4, 5, 3
    one = BatchShard(torch.Generator().manual_seed(2))
    whole = [one.keep(shape, 0.1, "cpu")
             for _, shape in ppipe._sites(cfg.t5, B, L, T)]
    sites = [site for site, _ in ppipe._sites(cfg.t5, B, L, T)]
    for s in range(n_pipe):
        got = ppipe.stage_masks(
            BatchShard(torch.Generator().manual_seed(2)), cfg,
            pmesh.Mesh(1, n_pipe, 1, rank=s), B, L, T, "cpu")
        per = 4 // n_pipe
        for stack in ("enc", "dec"):
            want = [m for site, m in zip(sites, whole)
                    if isinstance(site, tuple) and site[0] == stack
                    and site[1] // per == s]
            assert len(got[stack]) == len(want) == per * (
                3 if stack == "enc" else 4)
            assert all(torch.equal(a, b) for a, b in zip(got[stack], want))
        held = {"enc_final"} | ({"enc_in", "dec_in"} if s == 0 else set()) \
            | ({"dec_final"} if s == n_pipe - 1 else set())
        assert set(got) - {"enc", "dec"} == held
        for site in held:
            assert torch.equal(got[site][0], whole[sites.index(site)])


@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_recompute_matches_autograd(causal):
    """The backward the card runs for K8 (scores recomputed) against
    autograd through the plain flash version, fp32: dq, dk, dv and the
    summed (1, H) bias gradient within 1e-5 of each one's largest."""
    gen = torch.Generator().manual_seed(3)
    B, H, L, D = 2, 4, 9, 64
    q, k, v = (torch.randn(B, H, L, D, generator=gen).requires_grad_()
               for _ in range(3))
    bias = torch.randn(1, H, L, L, generator=gen).requires_grad_()
    mask = torch.ones(B, L, dtype=torch.int32)
    mask[1, 6:] = 0
    out = pattention.flash_attention_reference(q, k, v, bias, mask,
                                               causal=causal)
    g = torch.randn(out.shape, generator=gen)
    want = torch.autograd.grad(out, (q, k, v, bias), g)
    got = pattention._flash_bwd(q.detach(), k.detach(), v.detach(),
                                bias.detach(), mask, causal, 1.0, g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---------------------------------------------------------------------------
# Gloo processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("load", LOADS)
def test_pipelined_step_matches_jax(runs, load):
    """One AdamW step at dropout 0 (2 microbatches): the loss within 1e-5
    relative of the JAX step's, every parameter, gathered from the stages,
    within the JAX test's bounds; the shard -> gather round trip exact."""
    ranks = runs["ranks"][load]
    want = runs["jax"][load]
    for r in ranks:
        assert abs(float(r["step/loss"][0]) - want["loss"]) <= 1e-5 * abs(
            want["loss"])
        assert bool(r["roundtrip"])
    for n, w in want["params"].items():
        np.testing.assert_allclose(ranks[0][f"step/{n}"], w, rtol=1e-3,
                                   atol=5e-4, err_msg=n)


@pytest.mark.parametrize("load", LOADS)
def test_pipelined_gradients_are_whole(runs, load):
    """Each rank's step-1 gradients as AdamW receives them (summed over the
    axes along which they are partial) against one process's, cut to the
    rank's pieces: within 1e-5 of each leaf's largest value, the shared
    embedding, the ``rel_bias`` tables and the layer norms included."""
    for r in runs["ranks"][load]:
        names = [k[5:] for k in r if k.startswith("grad/")]
        assert "t5.shared" in names
        for n in names:
            g, w = r[f"grad/{n}"], r[f"gradref/{n}"]
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                     1e-30), n


@pytest.mark.parametrize("load", LOADS)
def test_eval_loss_over_four_microbatches(runs, load):
    """More microbatches than stages: the eval loss equals one process's
    within 1e-6 relative."""
    for r in runs["ranks"][load]:
        np.testing.assert_allclose(r["eval4/loss"], r["eval4/ref"],
                                   rtol=1e-6)


def _shared(ranks, load, name):
    """Groups of ranks that hold ``name`` whole and must agree on it."""
    _, world, _ = worker.MODEL_PARALLEL[load]
    n_model = 2 if load == "tp_pp" else 1
    split_pipe, kind = pmesh.param_spec(name, 2, n_model)
    if kind is not None:
        return []
    if split_pipe:  # a stage's layer: its model ranks
        return [[ranks[r] for r in range(world) if r // n_model == s]
                for s in range(2)]
    return [ranks]


@pytest.mark.parametrize("load", LOADS)
def test_pipelined_dropout_steps_match_one_process(runs, load):
    """Three steps at dropout 0.1 (each stage's part of one process's
    masks): the losses within 1e-5 of one process's on every rank; every
    leaf that ranks share bit-equal on them (the embeddings and norms on
    both stages, the block norms on a stage's model ranks)."""
    ranks = runs["ranks"][load]
    for r in ranks:
        np.testing.assert_allclose(r["drop/losses"], r["drop/ref"],
                                   rtol=1e-5, atol=0)
    for k in ranks[0]:
        if not k.startswith("after/"):
            continue
        for group in _shared(ranks, load, k[6:]):
            for r in group[1:]:
                np.testing.assert_array_equal(r[k], group[0][k], err_msg=k)


@pytest.mark.parametrize("load", LOADS)
def test_pipelined_cli_train_test_and_resume_match_one_process(runs, load):
    """``cli.py --train --test`` over the multihost flags (2 epochs), then
    ``--resume --test``: one process's losses, answers and performance."""
    check_cli_runs(runs["root"], load, runs["one"])
