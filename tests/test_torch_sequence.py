"""The port's sequence parallelism (ring attention over "seq") against the
JAX package and one process, on the CPU.

In-process: ``parallel/mesh.build_mesh`` builds the JAX ``get_seq_mesh``
shapes and device order and refuses what the JAX ``_build_mesh`` refuses,
with its messages; ``sp_t5_encode`` raises the JAX ``ValueError`` for a
shape that does not divide; the training experiment refuses the head and
BAN variants under "seq" with the JAX message.

Four gloo processes (``tests/torch_multihost_worker.py --load sp``: data 2
x seq 2) on the JAX ``tests/test_sequence.py`` configuration, against the
JAX ``parallel/sequence.py`` functions on a (data 2, seq 2) mesh of the
virtual CPU devices from the same init and inputs: ring attention (plain;
T5's scale 1 with a position bias and a key mask with a fully masked row;
causal) and its q, k, v gradients within 1e-5; ``sp_t5_encode`` at L =
4,096 (row 1 padded across the chunk boundary) within 2e-5, and of one
process's ``t5_encode`` under "xla"; the SP loss within ``rtol=2e-5``;
three SP train steps (L = 17 over seq 2: a masked tail) within the JAX
``test_sp_train_step_matches_dp`` bounds; against one process: each
rank's summed gradients, three steps at dropout 0.1 with one process's
masks within 1e-5, and ``cli.py --train --test`` then ``--resume --test``
under ``{"seq": 2}`` within ``rtol=2e-3`` of one process's losses with its
answers, the checkpoint loading in one process.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import sequence as jsp  # noqa: E402
from multimodalpromptretrieval_tpu.train import experiment as jexperiment  # noqa: E402
from multimodalpromptretrieval_tpu.train.optim import (  # noqa: E402
    adamw_init as jadamw_init,
)
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import t5 as pt5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.attention import (  # noqa: E402
    multi_head_attention,
)
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import multihost  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import (  # noqa: E402
    sequence as psequence,
)
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
    load_ranks,
    one_process_cli,
    port_tree,
    write_inputs,
)

SPAWN_TIMEOUT = 300
LAYERS = worker.MODEL_PARALLEL["sp"][2]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_ring_grads(mesh, case, inputs):
    """jax.grad of the summed squares of the JAX ring attention's output
    over the mesh (``tests/test_sequence.py``'s ``loss_ring``)."""
    from jax import shard_map

    make_kw, call_kw = worker.sp_case(case, inputs)
    q = inputs["q"]
    B, H, L, _ = q.shape
    bias = call_kw.get("bias", np.zeros((1, H, L, L), np.float32))
    mask = call_kw.get("kv_mask", np.ones((B, L), bool))
    spec = P("data", None, "seq", None)

    def loss(q, k, v):
        def local(q, k, v, bias, mask):
            o = jsp.ring_attention(q, k, v, axis="seq", n_ranks=2,
                                   bias=bias, kv_mask=mask, **make_kw)
            return jax.lax.psum(jax.lax.psum(jnp.sum(o ** 2), "seq"),
                                "data")

        return shard_map(local, mesh=mesh,
                         in_specs=(spec, spec, spec, P(), P("data", "seq")),
                         out_specs=P(), check_vma=False)(
            q, k, v, jnp.asarray(bias), jnp.asarray(mask))

    sh = NamedSharding(mesh, spec)
    args = [jax.device_put(jnp.asarray(inputs[n]), sh) for n in "qkv"]
    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]


def _jax_side(mesh, params, batch, cfg):
    """The JAX functions on the (data 2, seq 2) mesh: ring attention and
    its gradients per case, ``sp_t5_encode`` at L = 4,096, the SP loss
    and three SP train steps at dropout 0."""
    inputs = worker.sp_attention_inputs()
    out = {}
    for case in worker.SP_CASES:
        make_kw, call_kw = worker.sp_case(case, inputs)
        out[f"attn/{case}"] = np.asarray(jsp.make_sp_attention(
            mesh, **make_kw)(*(jnp.asarray(inputs[n]) for n in "qkv"),
                             **{k: jnp.asarray(v)
                                for k, v in call_kw.items()}))
        for name, g in zip("qkv", _jax_ring_grads(mesh, case, inputs)):
            out[f"grad/{case}/{name}"] = g
    embeds, mask = worker.sp_encode_inputs(cfg.t5.d_model)
    out["encode"] = np.asarray(jsp.sp_t5_encode(
        params["t5"], cfg.t5, jnp.asarray(embeds), jnp.asarray(mask), mesh))
    b = jmesh.shard_batch(batch, mesh)
    out["eval/loss"] = float(jsp.make_eval_loss_step_sp(cfg, mesh=mesh)(
        params, b))
    step = jsp.make_train_step_sp(cfg, jmprgen.trainable_mask(params, cfg),
                                  mesh=mesh, donate=False)
    p, opt, losses = params, jadamw_init(params), []
    for i in range(worker.STEPS):
        p, opt, loss = step(p, opt, b, jnp.float32(1e-3), None)
        losses.append(float(loss))
        if i == 0:
            out["step1"] = port_tree(p, LAYERS)
    out["steps/losses"] = np.asarray(losses)
    return out


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The "sp" load in four gloo processes; meanwhile, here, the JAX side
    and one process's cli runs."""
    root = str(tmp_path_factory.mktemp("torch_sp"))
    params, batch, cfg = write_inputs(root, LAYERS)
    worker.write_cli_inputs(root, ["sp"])
    procs = worker.spawn("sp", root, worker.MODEL_PARALLEL["sp"][1])
    try:
        jax_res = _jax_side(jsp.get_seq_mesh(n_data=2, n_seq=2), params,
                            batch, cfg)
        one = one_process_cli(root)
    finally:
        fail = worker.finish(procs, SPAWN_TIMEOUT)
    assert not fail, "\n".join(fail)
    return {"root": root, "ranks": load_ranks(root, "sp"), "jax": jax_res,
            "one": one, "jparams": params, "cfg": cfg}


# ---------------------------------------------------------------------------
# In-process
# ---------------------------------------------------------------------------


def _on_devices(monkeypatch, n):
    devices = jax.devices()[:n]
    monkeypatch.setattr(jexperiment.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(jsp.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)


@pytest.mark.parametrize("parallelism,n", [
    ({"seq": 2}, 2), ({"seq": 2}, 4), ({"seq": 4}, 4), ({"seq": 4}, 8),
    ({"data": 2, "seq": 2}, 4), ({"data": 4, "seq": 2}, 8)])
def test_build_mesh_matches_jax_seq_mesh(monkeypatch, parallelism, n):
    """The JAX ("data", "seq") mesh's axis sizes, and its device grid is
    the port's rank grid: rank = d * n_seq + s; every rank's coordinates
    map back to it."""
    _on_devices(monkeypatch, n)
    cfg = {"parallelism": parallelism, "hyperparameters": {"batch_size": 8}}
    jm = jexperiment.Experiment._build_mesh(cfg)
    mesh = pmesh.build_mesh(cfg)
    assert mesh.shape == {"data": jm.shape["data"], "seq": jm.shape["seq"],
                          "model": 1, "pipe": 1}
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    ranks = np.asarray([[mesh.rank_of(d, 0, 0, s)
                         for s in range(mesh.n_seq)]
                        for d in range(mesh.n_data)])
    np.testing.assert_array_equal(grid, ranks)
    for rank in range(n):
        m = pmesh.Mesh(mesh.n_data, n_seq=mesh.n_seq, rank=rank)
        assert m.rank_of(m.index, 0, 0, m.seq_index) == rank
        assert m.seq.ranks == [m.index * mesh.n_seq + s
                               for s in range(mesh.n_seq)]


@pytest.mark.parametrize("parallelism,batch_size,n", [
    ({"seq": 2, "model": 2}, 8, 4), ({"seq": 2, "pipe": 2}, 8, 4),
    ({"seq": 3}, 8, 4), ({"data": 3, "seq": 2}, 8, 8),
    ({"data": 4, "seq": 2}, 8, 4)])
def test_seq_refused_as_in_jax(monkeypatch, parallelism, batch_size, n):
    """"seq" with "model" or "pipe", a width that does not divide the
    processes, a "data" that does not divide the batch or exceeds them:
    the JAX checks, with its messages."""
    _on_devices(monkeypatch, n)
    cfg = {"parallelism": parallelism,
           "hyperparameters": {"batch_size": batch_size}}
    with pytest.raises(ValueError) as want:
        jexperiment.Experiment._build_mesh(cfg)
    with pytest.raises(ValueError) as got:
        pmesh.build_mesh(cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(2, 65), (3, 64)])
def test_sp_t5_encode_rejects_indivisible_shapes(shape):
    """A batch or a length that does not divide its axis: the JAX
    ``ValueError`` text, before any collective."""
    jcfg = worker.tiny_model_cfg(2).t5
    embeds = np.zeros(shape + (jcfg.d_model,), np.float32)
    from multimodalpromptretrieval_tpu.models import t5 as jt5

    jparams = jt5.init_t5(jax.random.PRNGKey(7), jt5.T5Config.tiny(64))
    with pytest.raises(ValueError) as want:
        jsp.sp_t5_encode(jparams, jt5.T5Config.tiny(64),
                         jnp.asarray(embeds), None,
                         jsp.get_seq_mesh(n_data=2, n_seq=2))
    with pytest.raises(ValueError) as got:
        psequence.sp_t5_encode(None, jcfg, torch.from_numpy(embeds), None,
                               pmesh.Mesh(2, n_seq=2, rank=0))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("variant", [{"use_prediction_head": 1},
                                     {"use_prediction_head": 1,
                                      "use_BAN": 1}])
def test_head_and_ban_refused_under_seq(monkeypatch, variant):
    """The training experiment refuses the head and BAN variants under
    ``{"seq": 2}`` with the JAX ``_check_sp_config`` message."""
    _on_devices(monkeypatch, 2)
    splits, images = synthetic_slake(2, 1, image_size=32, n_validate=1)
    cfg = synthetic_config(batch_size=8, image_size=32)
    cfg["clip_overrides"]["patch_size"] = 16
    cfg.update(variant, parallelism={"seq": 2})
    with pytest.raises(ValueError) as want:
        jexperiment.Experiment._check_sp_config(None, cfg)
    with pytest.raises(ValueError) as got:
        TrainingExperiment(copy.deepcopy(cfg), train=splits["train"],
                           validate=splits["validate"], images=images,
                           device="cpu", quiet=True)
    assert str(got.value) == str(want.value)


def test_merge_sums_every_gradient_over_data_and_seq():
    """Under "seq" the merge's one all_reduce spans "data" and "seq"
    together: every process (the default group)."""
    for rank in range(4):
        mesh = pmesh.Mesh(2, n_seq=2, rank=rank)
        axis = mesh.batch_axes
        assert (axis.size, axis.index, axis.group) == (4, rank, None)
        assert pmesh.partial_axes("t5.encoder.rel_bias", mesh) == (
            False, False)


# ---------------------------------------------------------------------------
# Four processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", worker.SP_CASES)
def test_ring_attention_matches_jax(sp, case):
    """``make_sp_attention`` on every rank: within 1e-5 of the JAX
    ``make_sp_attention`` and of one process's ``multi_head_attention``
    under "xla" (the T5 case's fully masked row included)."""
    inputs = worker.sp_attention_inputs()
    make_kw, call_kw = worker.sp_case(case, inputs)
    one = multi_head_attention(
        *(torch.from_numpy(inputs[n]) for n in "qkv"),
        **{k: torch.from_numpy(v) for k, v in call_kw.items()},
        impl="xla", **make_kw).numpy()
    for r in sp["ranks"]:
        got = r[f"attn/{case}"]
        np.testing.assert_allclose(got, sp["jax"][f"attn/{case}"],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", worker.SP_CASES)
def test_ring_gradients_match_jax_grad(sp, case):
    """dq, dk, dv of the summed squares (the ring's backward hops carrying
    dk and dv home), gathered: within 1e-5 of ``jax.grad`` of the JAX ring
    on every rank."""
    for r in sp["ranks"]:
        for name in "qkv":
            key = f"grad/{case}/{name}"
            np.testing.assert_allclose(r[key], sp["jax"][key], atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def test_sp_t5_encode_at_4096_matches_jax_and_one_process(sp):
    """The whole encoder at L = 4,096 over (data 2, seq 2), the position
    bias per tile: within 2e-5 of the JAX ``sp_t5_encode`` and of one
    process's ``t5_encode`` under "xla" (row by row, the (H, L, L) bias
    of one row at a time)."""
    cfg = worker.tiny_model_cfg(LAYERS)
    full = bridge.params_from_jax(sp["jparams"], cfg)
    embeds, mask = worker.sp_encode_inputs(cfg.t5.d_model)
    with torch.no_grad():
        one = np.concatenate([pt5.t5_encode(
            full.t5, cfg.t5, torch.from_numpy(embeds[i:i + 1]),
            torch.from_numpy(mask[i:i + 1])).numpy() for i in range(2)])
    pt5._buckets.cache_clear()
    for r in sp["ranks"]:
        np.testing.assert_allclose(r["encode"], sp["jax"]["encode"],
                                   atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(r["encode"], one, atol=2e-5, rtol=2e-5)


def test_sp_loss_matches_jax(sp):
    """The SP eval loss (L = 17 over seq 2, a masked zero tail): within
    ``rtol=2e-5`` of the JAX SP loss, the same on every rank."""
    losses = [float(r["eval/loss"]) for r in sp["ranks"]]
    np.testing.assert_allclose(losses[0], sp["jax"]["eval/loss"], rtol=2e-5)
    assert all(x == losses[0] for x in losses)


def test_sp_train_steps_match_jax_sp_step(sp):
    """Three SP steps at dropout 0: the losses within ``rtol=1e-5`` of the
    JAX SP step's, the parameters after the first within its bounds
    (``rtol=1e-3, atol=5e-4``: AdamW's first step amplifies eps-scale
    noise), the same on every rank."""
    want = sp["jax"]
    for r in sp["ranks"]:
        np.testing.assert_allclose(r["steps/losses"], want["steps/losses"],
                                   rtol=1e-5)
        for n, w in want["step1"].items():
            np.testing.assert_allclose(r[f"step1/{n}"], w, rtol=1e-3,
                                       atol=5e-4, err_msg=n)
            np.testing.assert_array_equal(r[f"step1/{n}"],
                                          sp["ranks"][0][f"step1/{n}"])


def test_sp_gradients_are_one_process_gradients(sp):
    """Each rank's step-1 gradients as AdamW receives them (summed over
    "data" and "seq"): every trainable leaf within 1e-5 of its largest
    value of one process's, bit-equal on the four ranks; the losses of
    the three steps within 1e-5 of one process's."""
    r0 = sp["ranks"][0]
    names = [k[6:] for k in r0 if k.startswith("sgrad/")]
    assert names and any(n.endswith("rel_bias") for n in names)
    for r in sp["ranks"]:
        assert sorted(k[9:] for k in r if k.startswith("sgradref/")) == \
            sorted(names)
        for n in names:
            g, w = r[f"sgrad/{n}"], r[f"sgradref/{n}"]
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(),
                                                     1e-30), n
            np.testing.assert_array_equal(g, r0[f"sgrad/{n}"])
        np.testing.assert_allclose(r["steps/losses"], r["steps/ref"],
                                   rtol=1e-5)


def test_sp_dropout_steps_match_one_process(sp):
    """Three steps at dropout 0.1 with one process's masks (each site
    drawn at the global batch's shape and unpadded length, each rank
    keeping its rows and chunk): within 1e-5 of one process's losses with
    the same generator, falling, the same on every rank."""
    r0 = sp["ranks"][0]
    np.testing.assert_allclose(r0["drop/losses"], r0["drop/ref"], rtol=1e-5,
                               atol=0)
    assert r0["drop/losses"][-1] < r0["drop/losses"][0]
    for r in sp["ranks"]:
        np.testing.assert_array_equal(r["drop/losses"], r0["drop/losses"])


def test_sp_cli_train_test_and_resume_match_one_process(sp):
    """``cli.py --train --test`` (2 epochs) then ``--resume --test`` over
    the multihost flags under ``{"seq": 2}`` (four processes: data 2 x
    seq 2, L = 37 over seq 2, a masked tail)."""
    check_cli_runs(sp["root"], "sp", sp["one"])


def test_forced_gates_steer_the_relu_backward(tmp_path):
    """``worker.forced_gates``, which the card's SP gradient check uses to
    give one process the SP forward's ReLU gates: with a forward's own
    gates it changes no gradient bit; with one gate of the last decoder
    block set apart it counts that one gate, leaves none apart, and the
    block's ``ff.wi`` gradient moves."""
    exp = worker.tiny_experiment(str(tmp_path / "logs"),
                                 str(tmp_path / "models"), 0.0)
    batch = worker.first_batch(exp)
    gates = {n: torch.from_numpy(np.unpackbits(g, axis=-1).astype(bool))
             for n, g in worker.relu_gates(exp, batch).items()}
    plain = worker.block_grads(exp, batch, 1)
    with worker.forced_gates(exp, gates) as seen:
        same = worker.block_grads(exp, batch, 1)
    assert sorted(seen) == sorted(gates) and len(gates) == 4
    assert all(v == [0, 0] for v in seen.values())
    assert sorted(same) == sorted(plain)
    for n in plain:
        np.testing.assert_array_equal(same[n], plain[n], err_msg=n)
    leaf = max(n for n in gates if ".decoder." in n)
    gates[leaf].view(-1)[0] ^= True
    with worker.forced_gates(exp, gates) as seen:
        moved = worker.block_grads(exp, batch, 1)
    assert seen[leaf] == [1, 0]
    assert sum(v[0] for v in seen.values()) == 1
    assert not np.array_equal(moved[leaf], plain[leaf])


def test_forced_gates_record_and_replay_forward_by_forward(tmp_path):
    """``worker.forced_gates`` with ``record`` keeps each forward's own
    gates, a list by weight, and changes no gradient bit; given those
    lists, the forwards take them back in call order (two row blocks: two
    forwards of each weight): no gate set apart, the gradients bit for bit,
    every list used up. One gate of the second forward set apart moves the
    gradient and is counted once."""
    exp = worker.tiny_experiment(str(tmp_path / "logs"),
                                 str(tmp_path / "models"), 0.0)
    batch = worker.first_batch(exp)
    plain = worker.block_grads(exp, batch, 2)
    gates = {}
    with worker.forced_gates(exp, gates, record=True) as seen:
        recorded = worker.block_grads(exp, batch, 2)
    assert not seen and len(gates) == 4
    assert all(len(v) == 2 and v[0].device.type == "cpu"
               for v in gates.values())
    kept = {n: [g.clone() for g in v] for n, v in gates.items()}
    with worker.forced_gates(exp, gates) as seen:
        same = worker.block_grads(exp, batch, 2)
    assert sorted(seen) == sorted(kept)
    assert all(v == [0, 0] for v in seen.values())
    assert not any(gates.values())
    for n in plain:
        np.testing.assert_array_equal(recorded[n], plain[n], err_msg=n)
        np.testing.assert_array_equal(same[n], plain[n], err_msg=n)
    leaf = max(n for n in kept if ".decoder." in n)
    kept[leaf][1].view(-1)[0] ^= True
    with worker.forced_gates(exp, kept) as seen:
        moved = worker.block_grads(exp, batch, 2)
    assert seen[leaf] == [1, 0]
    assert sum(v[0] for v in seen.values()) == 1
    assert not np.array_equal(moved[leaf], plain[leaf])
