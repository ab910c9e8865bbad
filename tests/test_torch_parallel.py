"""The port's data parallelism against one process and the JAX package, on
the CPU.

The ``parallelism`` config key is honoured or refused as the JAX
``_build_mesh`` does it, with its messages (``{"model": 2}`` on one process
raises the JAX package's ``ValueError``); tensor and pipeline parallelism
build the JAX mesh (their steps: ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_pipeline.py``); what only the JAX package runs
(sequence parallelism, a mesh that leaves devices idle) raises. The
pieces of a data-parallel step: each process's rows, the global longest
prompt, the loss weights and the dropout masks drawn at the
global batch's shape. The merge of per-shard L2 top-k results equals the
JAX ``sharded_l2_topk`` on a 4-device mesh, ties and ``skip_first``
included. Two gloo processes (``tests/torch_multihost_worker.py``) train
to one process's losses, step-1 gradients and parameters within 1e-6
(three steps at dropout 0 and 0.1, one epoch of ``train()`` and its
``test()``), only rank 0 writes, and their ``sharded_l2_topk`` equals one
``l2_topk``.
"""

import copy
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.parallel import (  # noqa: E402
    retrieval as jretrieval,
)
from multimodalpromptretrieval_tpu.train import experiment as jexperiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import layers  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import multihost  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import (  # noqa: E402
    retrieval as pretrieval,
)
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)

import torch_multihost_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on_devices(monkeypatch, n):
    """The JAX package and the port both see ``n`` devices / processes."""
    devices = jax.devices()[:n]
    monkeypatch.setattr(jexperiment.jax, "devices", lambda *a: devices)
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)


def _cfg(parallelism, batch_size=8):
    return {"parallelism": parallelism,
            "hyperparameters": {"batch_size": batch_size}}


# ---------------------------------------------------------------------------
# The parallelism key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parallelism,batch_size,n", [
    ({"model": 2}, 8, 1), ({"seq": 2, "model": 2}, 8, 4),
    ({"data": 3}, 8, 4), ({"data": 4}, 8, 2), ({"pipe": 3}, 8, 4),
    ({"data": 2, "model": 2}, 8, 2)])
def test_parallelism_key_refused_as_in_jax(monkeypatch, parallelism,
                                           batch_size, n):
    """The JAX checks, in its order and with its messages."""
    _on_devices(monkeypatch, n)
    cfg = _cfg(parallelism, batch_size)
    with pytest.raises(ValueError) as want:
        jexperiment.Experiment._build_mesh(cfg)
    with pytest.raises(ValueError) as got:
        pmesh.build_mesh(cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cls", [ServingExperiment, TrainingExperiment])
def test_model_parallelism_on_one_process_raises_the_jax_error(
        monkeypatch, cls):
    """``{"model": 2}`` on one process: the experiments raise the JAX
    package's ``ValueError`` before any work."""
    devices = jax.devices()[:1]
    monkeypatch.setattr(jexperiment.jax, "devices", lambda *a: devices)
    splits, images = synthetic_slake(2, 1, image_size=32, n_validate=1)
    cfg = synthetic_config(batch_size=8, image_size=32)
    cfg["clip_overrides"]["patch_size"] = 16
    cfg["parallelism"] = {"model": 2}
    with pytest.raises(ValueError) as want:
        jexperiment.Experiment._build_mesh(cfg)
    assert "1 available devices" in str(want.value)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        cls(copy.deepcopy(cfg), train=splits["train"],
            validate=splits["validate"], test=splits["test"], images=images,
            device="cpu")


@pytest.mark.parametrize("parallelism,batch_size,n,error,jax_shape", [
    ({"model": 2}, 8, 2, None, {"data": 1, "model": 2}),
    ({"data": 2, "pipe": 2}, 8, 4, None, {"data": 2, "pipe": 2}),
    ({"seq": 2}, 8, 2, None, {"data": 1, "seq": 2}),
    ({}, 6, 4, ValueError, {"data": 3, "model": 1}),
    ({"data": 1}, 8, 2, ValueError, {"data": 1, "model": 1}),
    ({}, 8, 2, None, {"data": 2, "model": 1}),
    ({"data": 4}, 8, 4, None, {"data": 4, "model": 1})])
def test_parallelism_key_beyond_data_parallelism(monkeypatch, parallelism,
                                                 batch_size, n, error,
                                                 jax_shape):
    """What passes the JAX checks: data, tensor, pipeline and sequence
    parallelism over every process build the JAX mesh's shape; a data axis
    that leaves processes idle (the JAX package's unused devices) raises
    naming the shrink."""
    _on_devices(monkeypatch, n)
    cfg = _cfg(parallelism, batch_size)
    assert dict(jexperiment.Experiment._build_mesh(cfg).shape) == jax_shape
    if error is None:
        mesh = pmesh.build_mesh(cfg)
        assert mesh.shape == dict({"data": 1, "model": 1, "pipe": 1,
                                   "seq": 1}, **jax_shape)
        return
    match = f"uses {jax_shape['data']} of the {n} processes"
    with pytest.raises(error, match=match):
        pmesh.build_mesh(cfg)


# ---------------------------------------------------------------------------
# The pieces of a data-parallel step
# ---------------------------------------------------------------------------


def _batch(rng, B=8, L=6, T=4):
    mask = np.ones((B, L), np.int32)
    for r, n in enumerate(rng.integers(2, L + 1, size=B)):
        mask[r, n:] = 0
    labels = rng.integers(2, 30, size=(B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.3] = -100
    classes = rng.integers(0, 5, size=B).astype(np.int32)
    classes[-1] = -100
    return {k: torch.from_numpy(v) for k, v in dict(
        input_ids=rng.integers(2, 30, size=(B, L)).astype(np.int32),
        text_mask=mask, labels=labels, class_labels=classes).items()}


@pytest.mark.parametrize("head", [False, True])
def test_shard_rows_longest_and_loss_weights(head):
    """Contiguous row blocks; ``longest`` is the global batch's; the loss
    weights are each rank's share of the valid targets and sum to 1."""
    batch = _batch(np.random.default_rng(0))
    batch["text_mask"][:, -1] = 0
    batch["text_mask"][6, :] = 1  # the longest prompt, on rank 3 of 4
    cfg = pmprgen.MPRGenConfig(T5Config(), CLIPConfig(),
                               use_prediction_head=head)
    weights = []
    for r in range(4):
        mesh = pmesh.Mesh(4, rank=r)
        local = pmesh.shard_batch(batch, mesh)
        for k in batch:
            assert torch.equal(local[k], batch[k][2 * r:2 * r + 2])
        assert int(local["longest"]) == 6
        weights.append(pmesh.loss_weight(cfg, batch, local))
    valid = (batch["class_labels"] >= 0) if head else (
        batch["labels"] != -100)
    assert torch.allclose(torch.stack(weights), torch.stack(
        [valid[2 * r:2 * r + 2].sum() / valid.sum() for r in range(4)]
    ).float(), rtol=0, atol=0)
    assert abs(float(sum(weights)) - 1.0) <= 1e-6


def test_batch_shard_dropout_keeps_the_global_masks():
    """Each rank's masks are its rows of the masks one process draws over
    the global batch from the same generator state."""
    x = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(1))
    whole = layers.dropout(x, 0.3, torch.Generator().manual_seed(3))
    parts = [layers.dropout(x[4 * r:4 * r + 4], 0.3, layers.BatchShard(
        torch.Generator().manual_seed(3), r, 2)) for r in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(parts[0], parts[1])


@pytest.mark.parametrize("kind", ["head", "ban"])
def test_head_rows_read_the_global_longest_prompt(kind):
    """A head variant on a rank's rows, given the global batch's longest
    prompt, gives those rows' logits of the whole batch."""
    cfg = pmprgen.MPRGenConfig(
        t5=T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32,
                    num_layers=1, num_decoder_layers=1, num_heads=2),
        clip=CLIPConfig(embed_dim=16, image_resolution=32, vision_layers=1,
                        vision_width=16, patch_size=16, context_length=16,
                        vocab_size=64, text_width=16,
                        vision_heads_override=2, text_heads_override=2),
        use_prediction_head=True, use_ban=kind == "ban", num_classes=5)
    params = pmprgen.init_mprgen(cfg, 0)
    batch = _batch(np.random.default_rng(1))
    batch["text_mask"][2:, 4:] = 0
    batch["text_mask"][:2, :] = 1  # the longest prompts: rank 0's rows
    batch["images"] = torch.randn(8, 3, 32, 32)
    logits = (pmprgen.ban_logits if kind == "ban" else pmprgen.head_logits)
    with torch.no_grad():
        whole = logits(params, cfg, batch["images"], batch["input_ids"],
                       batch["text_mask"])
        local = pmesh.shard_batch(batch, pmesh.Mesh(4, rank=2))
        part = logits(params, cfg, local["images"], local["input_ids"],
                      local["text_mask"], longest=local["longest"])
        alone = logits(params, cfg, local["images"], local["input_ids"],
                       local["text_mask"])
    torch.testing.assert_close(part, whole[4:6], rtol=0, atol=1e-6)
    assert not torch.allclose(alone, whole[4:6], atol=1e-4)


# ---------------------------------------------------------------------------
# The sharded top-k
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_topk():
    """The JAX ``sharded_l2_topk`` on a 4-device mesh at the largest fetch
    of the cases: its ranking's prefixes are the smaller top-k (one
    compile instead of one per k)."""
    query, index = worker.topk_data()
    jm = jmesh.get_mesh(n_data=4)
    jidx, n = jretrieval.pad_index_for_mesh(jnp.asarray(index.numpy()), jm)
    fetch = max(k + skip for k, skip in worker.TOPK_CASES["tiny"])
    d, i = jretrieval.sharded_l2_topk(jnp.asarray(query.numpy()), jidx, n,
                                      fetch, mesh=jm)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("k,skip", worker.TOPK_CASES["tiny"])
def test_merge_of_shard_results_matches_jax_sharded_topk(jax_topk, k, skip):
    """Per-shard ``l2_topk`` results of the padded 4-way split (squared
    distances), merged, equal the JAX ``sharded_l2_topk`` on a 4-device
    mesh: the same rows (ties to the lower row) and distances."""
    query, index = worker.topk_data()
    fetch = k + 1 if skip else k
    parts = []
    for s in range(4):
        block, n = pretrieval.pad_index_for_mesh(index,
                                                 pmesh.Mesh(4, rank=s))
        assert block.shape[0] == 10 and n == 37
        parts.append(pretrieval.local_topk(query, block, s, n, fetch))
    d, i = pretrieval.merge_candidates(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        fetch)
    if skip:
        d, i = d[:, 1:], i[:, 1:]
    d = torch.sqrt(torch.clamp(d, min=0.0))
    jd, ji = (x[:, int(skip):fetch] for x in jax_topk)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(d.numpy(), jd)
    whole_d, whole_i = l2_topk(query, index, k, skip_first=skip)
    np.testing.assert_array_equal(i.numpy(), whole_i.numpy())


# ---------------------------------------------------------------------------
# Two processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(rank 0's results, rank 1's, one process's, the root): two gloo
    processes of ``torch_multihost_worker.py`` on its tiny load, and
    :func:`worker.run` here with the step-1 gradients of the batch's two
    row blocks."""
    root = str(tmp_path_factory.mktemp("torch_dp"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_multihost_worker.py"),
         "--load", "tiny", "--rank", str(r), "--world", "2", "--port",
         str(port), "--root", root], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    fail = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=300)
            if p.returncode:
                fail.append(f"--- rank {r} rc={p.returncode} ---\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not fail, "\n".join(fail)
    single = worker.run("tiny", os.path.join(root, "single"),
                        os.path.join(root, "single_models"), blocks=2)
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(2)]
    return ranks[0], ranks[1], single, root


def _close(got, want, prefix, want_prefix=None):
    want_prefix = want_prefix or prefix
    names = [k[len(want_prefix):] for k in want if k.startswith(want_prefix)]
    assert names and sorted(names) == sorted(
        k[len(prefix):] for k in got if k.startswith(prefix))
    for k in names:
        np.testing.assert_allclose(got[prefix + k], want[want_prefix + k],
                                   rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("rate", worker.RATES["tiny"])
def test_two_process_train_steps_match_one_process(dp, rate):
    """Three data-parallel steps on the global batch of 8 (4 rows a
    process): the losses and every parameter within 1e-6 of one process's,
    at dropout 0 and at 0.1 (the masks drawn at the global batch's
    shape)."""
    r0, r1, single, _ = dp
    _close(r0, single, f"steps{rate}/")
    for k in r0:  # the replicas stay identical
        if k.startswith(f"steps{rate}/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("rate", worker.RATES["tiny"])
def test_two_process_step_gradients_match_one_process(dp, rate):
    """The summed gradients of step 1, as AdamW receives them, on both
    processes: within 1e-6 of one process's gradients of the same two row
    blocks, weighted and summed, and of its gradients of the whole
    batch."""
    r0, r1, single, _ = dp
    for r in (r0, r1):
        _close(r, single, f"grad{rate}/", f"blocks{rate}/")
        _close(r, single, f"grad{rate}/")


def test_two_process_train_epoch_and_test_match_one_process(dp):
    """``train()`` for one epoch (3 batches, the validation loss) and
    ``test()``: the losses, the parameters and the accuracy of one
    process."""
    r0, r1, single, _ = dp
    _close(r0, single, "train/")
    assert float(r0["test/overall"]) == float(single["test/overall"])
    assert float(r1["test/overall"]) == float(single["test/overall"])


def test_only_rank0_writes_checkpoint_and_logs(dp):
    """Rank 0 writes the checkpoint (once) and the loss and test logs; rank
    1 writes nothing; rank 0's performance file is one process's."""
    r0, r1, single, root = dp
    assert int(r0["saves"]) == 1 and int(r1["saves"]) == 0
    assert int(single["saves"]) == 1
    assert not os.path.exists(os.path.join(root, "rank1"))
    rank0 = os.listdir(os.path.join(root, "rank0"))
    perf = [f for f in rank0 if f.endswith("performance.txt")]
    assert len(perf) == 1
    with open(os.path.join(root, "rank0", perf[0])) as a, open(
            os.path.join(root, "single", perf[0])) as b:
        assert a.read() == b.read()
    assert len(os.listdir(os.path.join(root, "models"))) == 2  # npz, json


@pytest.mark.parametrize("k,skip", worker.TOPK_CASES["tiny"])
def test_two_process_sharded_topk_matches_one_k4(dp, k, skip):
    """``sharded_l2_topk`` over the group (a 19-row block a process, one
    padded) equals one ``l2_topk`` over the whole index on both ranks."""
    query, index = worker.topk_data()
    d, i = l2_topk(query, index, k, skip_first=skip)
    name = f"topk{len(index)}_{k}{skip}"
    for r in dp[:3]:
        np.testing.assert_array_equal(r[f"{name}/i"], i.numpy())
        np.testing.assert_array_equal(r[f"{name}/d"], d.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k,skip", [(15, False), (64, True)])
def test_cuda_merge_of_block_kernels_matches_one_kernel(k, skip):
    """On the card, the merge of K4 over two row blocks (squared distances)
    equals one K4 over the whole index, rows and distances, on normal rows
    where two squared distances often share a rounded square root."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(k)
    index = torch.randn(5001, 1024, generator=gen).to(dev)
    query = torch.randn(512, 1024, generator=gen).to(dev)
    fetch = k + 1 if skip else k
    parts = []
    for s in range(2):
        block, n = pretrieval.pad_index_for_mesh(index,
                                                 pmesh.Mesh(2, rank=s))
        parts.append(pretrieval.local_topk(query, block, s, n, fetch))
    d, i = pretrieval.merge_candidates(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        fetch)
    d = torch.sqrt(torch.clamp(d, min=0.0))
    if skip:
        d, i = d[:, 1:], i[:, 1:]
    want_d, want_i = l2_topk(query, index, k, skip_first=skip)
    assert torch.equal(i.int(), want_i) and torch.equal(d, want_d)
