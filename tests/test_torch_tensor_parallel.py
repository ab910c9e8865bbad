"""The port's tensor parallelism (Megatron TP over "model") against the JAX
package and one process, on the CPU.

In-process: ``parallel/mesh.build_mesh`` builds the JAX ``_build_mesh``
shapes and device order for "model", "pipe" and both, and refuses what it
refuses with its messages; the port's shard table matches the JAX
``_spec_for_path`` leaf by leaf; shard -> gather round trips are bit for bit
in every layout (the collective replayed in this process).

Two gloo processes (``tests/torch_multihost_worker.py --load tp``) on the
JAX ``tests/test_parallel.py`` tiny configuration, against the JAX TP step
on a (data 1, model 2) mesh of the virtual CPU devices from the same init
and batch: the loss within 1e-5 relative, the parameters after one AdamW
step within the JAX test's own bounds, the TP greedy ids identical; against
one process: each rank's gradients, layer norms included, whole; three
steps at dropout 0.1 within 1e-5 with the replicated leaves bit-equal on
both model ranks; ``cli.py --train --test`` (2 epochs) and ``--resume``
within ``rtol=2e-3`` of one process's losses, the same test() answers, and
the checkpoint loads in one process.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.train import experiment as jexperiment  # noqa: E402
from multimodalpromptretrieval_tpu.train.optim import (  # noqa: E402
    adamw_init as jadamw_init,
)
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import multihost  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)
from multimodalpromptretrieval_tpu_torch.train.optim import adamw_init  # noqa: E402

import torch_multihost_worker as worker  # noqa: E402
from torch_model_parallel_checks import (  # noqa: E402
    check_cli_runs,
    check_shard_table,
    load_ranks,
    one_process_cli,
    port_tree,
    write_inputs,
)

SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The "tp" load in two gloo processes; meanwhile, here, the JAX TP
    step and predict and one process's cli runs."""
    root = str(tmp_path_factory.mktemp("torch_tp"))
    params, batch, cfg = write_inputs(root, 2)
    worker.write_cli_inputs(root, ["tp"])
    procs = worker.spawn("tp", root, 2)
    try:
        trainable = jmprgen.trainable_mask(params, cfg)
        mesh = jmesh.get_mesh(n_data=1, n_model=2)
        ps = jmesh.param_shardings(params, mesh)
        step = jmesh.make_train_step(cfg, trainable, mesh=mesh,
                                     donate=False, param_sharding=ps)
        p_tp, _, loss = step(jmesh.shard_params(params, mesh),
                             jmesh.shard_params(jadamw_init(params), mesh),
                             jmesh.shard_batch(batch, mesh),
                             jnp.float32(1e-3), None)
        pbatch = {k: v for k, v in batch.items() if k != "labels"}
        ids = jmesh.make_predict_step(cfg, max_new_tokens=5, mesh=mesh,
                                      param_sharding=ps)(
            jmesh.shard_params(params, mesh),
            jmesh.shard_batch(pbatch, mesh))
        jax_res = {"loss": float(loss), "params": port_tree(p_tp, 2),
                   "ids": np.asarray(ids)}
        one = one_process_cli(root)
    finally:
        fail = worker.finish(procs, SPAWN_TIMEOUT)
    assert not fail, "\n".join(fail)
    return {"root": root, "ranks": load_ranks(root, "tp"), "jax": jax_res,
            "one": one}


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def _on_devices(monkeypatch, n):
    devices = jax.devices()[:n]
    monkeypatch.setattr(jexperiment.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)


@pytest.mark.parametrize("parallelism,batch_size,n", [
    ({"model": 2}, 8, 2), ({"model": 4}, 8, 8), ({"data": 2, "model": 2},
                                                  8, 4),
    ({"pipe": 2}, 8, 2), ({"pipe": 2}, 8, 4), ({"pipe": 4}, 8, 8),
    ({"pipe": 2, "model": 2}, 8, 4), ({"pipe": 2, "model": 2}, 8, 8),
    ({"pipe": 2, "microbatches": 4}, 8, 2)])
def test_build_mesh_matches_jax_shape_and_device_order(
        monkeypatch, parallelism, batch_size, n):
    """The JAX mesh's axis sizes, and its device grid is the port's rank
    grid: rank = (d * n_pipe + p) * n_model + m."""
    _on_devices(monkeypatch, n)
    cfg = {"parallelism": parallelism,
           "hyperparameters": {"batch_size": batch_size}}
    jm = jexperiment.Experiment._build_mesh(cfg)
    mesh = pmesh.build_mesh(cfg)
    want = dict(jm.shape)
    assert {k: v for k, v in mesh.shape.items() if k in want} == want
    assert all(v == 1 for k, v in mesh.shape.items() if k not in want)
    grid = np.vectorize(lambda d: d.id)(jm.devices).reshape(
        mesh.n_data, mesh.n_pipe, mesh.n_model)
    ranks = np.asarray([[[mesh.rank_of(d, p, m) for m in range(mesh.n_model)]
                         for p in range(mesh.n_pipe)]
                        for d in range(mesh.n_data)])
    np.testing.assert_array_equal(grid, ranks)
    for rank in range(n):
        coords = pmesh.Mesh(mesh.n_data, mesh.n_pipe, mesh.n_model, rank)
        assert mesh.rank_of(coords.index, coords.stage,
                            coords.model_index) == rank


@pytest.mark.parametrize("parallelism,batch_size,n", [
    ({"model": 3}, 8, 4), ({"pipe": 2, "model": 2}, 8, 2),
    ({"pipe": 3, "model": 2}, 8, 8), ({"data": 3, "model": 2}, 8, 8),
    ({"data": 4, "pipe": 2}, 8, 4)])
def test_model_and_pipe_refused_as_in_jax(monkeypatch, parallelism,
                                          batch_size, n):
    """The JAX checks of "model" and "pipe", with its messages."""
    _on_devices(monkeypatch, n)
    cfg = {"parallelism": parallelism,
           "hyperparameters": {"batch_size": batch_size}}
    with pytest.raises(ValueError) as want:
        jexperiment.Experiment._build_mesh(cfg)
    with pytest.raises(ValueError) as got:
        pmesh.build_mesh(cfg)
    assert str(got.value) == str(want.value)


def test_microbatches_key_reaches_the_pipelined_experiment(monkeypatch):
    """``parallelism.microbatches`` is the experiment's microbatch count (0:
    the stage count), read as the JAX ``Experiment`` reads it; stage 0 of
    2 holds the first half of each stack."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    splits, images = synthetic_slake(2, 1, image_size=32, n_validate=1)
    cfg = synthetic_config(batch_size=8, image_size=32)
    cfg["clip_overrides"]["patch_size"] = 16
    cfg["parallelism"] = {"pipe": 2, "microbatches": 4}
    exp = TrainingExperiment(copy.deepcopy(cfg), train=splits["train"],
                             validate=splits["validate"], images=images,
                             device="cpu", quiet=True)
    assert (exp.n_pipe, exp.n_model, exp.microbatches) == (2, 1, 4)
    assert len(exp.params.t5.encoder.block) == 1
    assert len(exp.params.t5.decoder.block) == 1


# ---------------------------------------------------------------------------
# The shard table and the round trips
# ---------------------------------------------------------------------------


def test_shard_table_matches_jax_spec_for_path():
    """TP over "model": q/k/v and wi columns, o and wo rows, the rest
    replicated, leaf by leaf as the JAX ``_spec_for_path``."""
    check_shard_table(1, 2, 2)


def simulate_gather(monkeypatch, fn, world: int):
    """``fn(rank)`` on each rank of a mesh of ``world`` processes, its one
    ``all_reduce`` replayed in this process: the sum of every rank's
    buffer. Returns each rank's result."""
    flats = []
    monkeypatch.setattr(pmesh.dist, "all_reduce",
                        lambda t, group=None: flats.append(t.clone()))
    for r in range(world):
        fn(r)
    total = sum(flats)
    monkeypatch.setattr(pmesh.dist, "all_reduce",
                        lambda t, group=None: t.copy_(total))
    return [fn(r) for r in range(world)]


@pytest.mark.parametrize("shape,pipe", [
    ((1, 1, 2), True), ((2, 1, 2), True), ((1, 2, 1), True),
    ((1, 2, 2), True), ((2, 2, 2), True), ((1, 2, 2), False)])
def test_shard_gather_round_trip_is_bit_exact(monkeypatch, shape, pipe):
    """Parameters and bf16 AdamW moments through ``shard_params`` /
    ``shard_state`` and back through ``gather_params`` / ``gather_state``
    on every rank: bit for bit; each rank's pieces are its layout's."""
    n_data, n_pipe, n_model = shape
    cfg = worker.tiny_model_cfg(4)
    full = pmprgen.init_mprgen(cfg, 0)
    state = adamw_init(full, "bfloat16")
    gen = torch.Generator().manual_seed(1)
    for t in state["mu"].values():
        t.copy_(torch.randn(t.shape, generator=gen))
    world = n_data * n_pipe * n_model

    def mesh_of(r):
        mesh = pmesh.Mesh(n_data, n_pipe, n_model, rank=r)
        return mesh if pipe else mesh.unpipelined()

    def params(r):
        local = pmesh.shard_params(full, cfg, mesh_of(r))
        qkv = local.t5.encoder.block[0].attn.qkv
        assert qkv.shape[0] == 3 * cfg.t5.inner_dim // n_model
        blocks = 4 // n_pipe if pipe else 4
        assert len(local.t5.decoder.block) == blocks
        return pmesh.gather_params(local, cfg, mesh_of(r))

    for back in simulate_gather(monkeypatch, params, world):
        for (n, a), (_, b) in zip(full.named_parameters(),
                                  back.named_parameters()):
            assert torch.equal(a, b) and a.dtype == b.dtype, n
    if pipe:
        def moments(r):
            local = pmesh.shard_state(state, cfg, mesh_of(r))
            return pmesh.gather_state(local, cfg, mesh_of(r))

        for back in simulate_gather(monkeypatch, moments, world):
            for n, t in state["mu"].items():
                assert back["mu"][n].dtype == torch.bfloat16
                assert torch.equal(back["mu"][n].view(torch.int16),
                                   t.view(torch.int16)), n


def test_replicated_rel_bias_gradient_is_partial_over_model_only():
    """The merge rule: under TP a replicated ``rel_bias`` sums over "model",
    a layer norm does not (the Megatron operators make it whole); under
    PP every stage-held leaf sums over "pipe"; a split table does not."""
    tp = pmesh.Mesh(1, 1, 2)
    assert pmesh.partial_axes("t5.encoder.rel_bias", tp) == (False, True)
    assert pmesh.partial_axes("t5.encoder.block.0.attn_ln", tp) == (
        False, False)
    pp = pmesh.Mesh(1, 2, 2)
    assert pmesh.partial_axes("t5.encoder.rel_bias", pp) == (True, False)
    assert pmesh.partial_axes("t5.shared", pp) == (True, False)
    assert pmesh.partial_axes("t5.decoder.block.0.ff_ln", pp) == (
        False, False)


# ---------------------------------------------------------------------------
# Two processes
# ---------------------------------------------------------------------------


def test_tp_step_matches_jax_tp_step(tp):
    """One AdamW step at dropout 0 on the (data 1, model 2) mesh: the loss
    within 1e-5 relative of the JAX TP step's, every parameter within its
    bounds (``tests/test_parallel.py``: rtol 2e-5, atol 2e-6)."""
    r0 = tp["ranks"][0]
    want = tp["jax"]
    assert abs(float(r0["step/loss"][0]) - want["loss"]) <= 1e-5 * abs(
        want["loss"])
    for n, w in want["params"].items():
        np.testing.assert_allclose(r0[f"step/{n}"], w, rtol=2e-5, atol=2e-6,
                                   err_msg=n)
    assert bool(r0["roundtrip"]) and bool(tp["ranks"][1]["roundtrip"])


def test_tp_greedy_ids_match_jax_tp_predict(tp):
    """The TP predict's greedy ids (5 tokens, 16 rows): identical to the JAX
    TP predict and to one process's."""
    for r in tp["ranks"]:
        np.testing.assert_array_equal(r["predict/ids"], tp["jax"]["ids"])
        np.testing.assert_array_equal(r["predict/ids"], r["predict/ref"])


def test_tp_gradients_are_whole_on_each_model_rank(tp):
    """Each rank's step-1 gradients, as AdamW receives them, against one
    process's cut to its pieces: within 1e-5 of the leaf's largest value,
    the layer norms and the summed ``rel_bias`` included; the replicated
    leaves' gradients bit-equal on both ranks."""
    r0, r1 = tp["ranks"]
    for r in (r0, r1):
        names = [k[5:] for k in r if k.startswith("grad/")]
        assert any(n.endswith("attn_ln") for n in names)
        for n in names:
            g, w = r[f"grad/{n}"], r[f"gradref/{n}"]
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                     1e-30), n
    for k in r0:
        if k.startswith("grad/") and pmesh.param_spec(k[5:], 1, 2)[1] is None:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_tp_dropout_steps_match_one_process(tp):
    """Three steps at dropout 0.1 (one process's masks, the FF hidden's
    columns of them on each rank): the losses within 1e-5 of one
    process's; every replicated leaf bit-equal on both model ranks."""
    r0, r1 = tp["ranks"]
    np.testing.assert_allclose(r0["drop/losses"], r0["drop/ref"], rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(r0["drop/losses"], r1["drop/losses"])
    for k in r0:
        if k.startswith("after/") and pmesh.param_spec(k[6:], 1, 2)[1] is None:
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_tp_cli_train_test_and_resume_match_one_process(tp):
    """``cli.py --train --test`` over the multihost flags under
    ``{"model": 2}`` (2 epochs), then ``--resume --test``."""
    check_cli_runs(tp["root"], "tp", tp["one"])


@pytest.mark.parametrize("variant", ["head", "ban"])
def test_tp_head_variants_match_one_process(tp, variant):
    """The prediction-head and BAN variants under ``{"model": 2}``: three
    steps at dropout 0.1 within 1e-5 of one process's losses; the step-1
    gradients within 1e-5 of each leaf's largest value of one process's
    plus 1e-7 (a softmax's shift, BAN's ``h_bias``, has a gradient of
    rounding noise)."""
    for r in tp["ranks"]:
        np.testing.assert_allclose(r[f"{variant}/losses"],
                                   r[f"{variant}/ref"], rtol=1e-5, atol=0)
        assert float(r[f"{variant}/grad_excess"]) <= 1e-7
