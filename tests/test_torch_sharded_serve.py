"""The port's data-sharded server against the JAX server on a data mesh and
against one process, on the CPU.

One synthetic SLAKE on disk (32-px images), three configurations (fp32,
row attention, chunk B = 4, ``{"data": 2}``): retrieval k = 1, k = 3, and
the prediction head at k = 3; each a seeded JAX init (pad embedding
zeroed, so that the greedy decodes carry text and run all 20 steps)
bridged into the port. The JAX ``Experiment`` + ``MPRServer`` on a data
mesh of two virtual CPU devices answer here; two gloo processes
(``tests/torch_multihost_worker.py --load serve``) run the port's
``MPRServer`` under ``{"data": 2}``, each chunk's rows split over the
processes: the fused path (k = 1 and 3), the host path
(``prompt_fastpath=False``), ``spec_decode=4``, ``length_sort``, the
head variant's per-batch path, for 3 and 9 requests (odd, below and above
B), two pipelined submits over staged images, and ``cli.serve_stream``.
Every rank's answers are the JAX server's and the port's one-process
server's, string for string, and every rank streams one process's
response lines.
"""

import copy
import io
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu import cli as jcli  # noqa: E402
from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)

import torch_multihost_worker as worker  # noqa: E402

SPAWN_TIMEOUT = 300
# configuration -> (k, prediction head)
CONFIGS = {"k1": (1, False), "k3": (3, False), "head": (3, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(root, k, head):
    """``tests/test_torch_serve.py``'s configuration under ``{"data":
    2}``."""
    cfg = synthetic_config(root, batch_size=4, epochs=1, image_size=32,
                           retrieval=True, k=k)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    cfg["t5_overrides"].update(vocab_size=117, attention_impl="row")
    cfg["cache_retrieval"] = False
    cfg["parallelism"] = {"data": 2}
    if head:
        cfg["use_prediction_head"] = 1
    return cfg


def _jax_answers(jexp, name):
    """The JAX server's answers of the worker's cases (as
    ``worker.serve_answers`` keys them) on the JAX data mesh."""
    images, questions, tasks, ids = worker.serve_requests(
        jexp.dataset_test.entries, jexp.images)
    res = {}
    for case, kw in worker.SERVE_CASES[name]:
        server = JServer(jexp, load_checkpoint=False, **kw)
        for n in worker.SERVE_SIZES:
            res[f"{name}/{case}/{n}"] = server.answer(
                images[:n], questions[:n], tasks[:n], image_ids=ids[:n])
    if name == "k3":
        out = io.StringIO()
        jcli.serve_stream(jexp, io.StringIO(worker.serve_stream_text(
            jexp.dataset_test.entries)), out)
        res["k3/stream"] = out.getvalue()
    return res


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX experiments and their bridged inits written; the "serve"
    load in two gloo processes; meanwhile, here, the JAX servers on a data
    mesh of two devices and the port's one-process servers."""
    root = str(tmp_path_factory.mktemp("torch_sharded_serve"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=16,
                             n_validate=8, n_test=8, image_size=32, seed=0)
    jexps = {}
    for name, (k, head) in CONFIGS.items():
        cfg = _config(root, k, head)
        with open(os.path.join(root, f"cfg_{name}.json"), "w") as f:
            json.dump(cfg, f)
        jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True,
                          log_root=os.path.join(root, "jax_logs"),
                          model_root=os.path.join(root, "jax_models"))
        shared = jexp.params["t5"]["shared"]
        jexp.params["t5"]["shared"] = shared.at[0].set(0.0)
        probe = ServingExperiment(
            dict({k: v for k, v in cfg.items() if k != "parallelism"},
                 retrieval=0), device="cpu")
        torch.save(bridge.params_from_jax(jexp.params,
                                          probe.model_cfg).state_dict(),
                   os.path.join(root, f"state_{name}.pt"))
        jexps[name] = jexp
    procs = worker.spawn("serve", root, 2)
    try:
        jax_res, one = {}, {}
        for name, jexp in jexps.items():
            assert dict(jexp.mesh.shape)["data"] == 2
            jax_res.update(_jax_answers(jexp, name))
            one.update(worker.serve_answers(
                worker.serve_experiment(root, name, parallelism=False),
                name))
    finally:
        fail = worker.finish(procs, SPAWN_TIMEOUT)
    assert not fail, "\n".join(fail)
    ranks = [{k: str(v) for k, v in np.load(
        os.path.join(root, f"serve_rank{r}.npz")).items()} for r in range(2)]
    return {"root": root, "ranks": ranks, "jax": jax_res, "one": one}


CASES = [(name, case, n) for name in worker.SERVE_CASES
         for case, _ in worker.SERVE_CASES[name] for n in worker.SERVE_SIZES]


@pytest.mark.parametrize("name,case,n", CASES)
def test_sharded_answers_match_jax_and_one_process(served, name, case, n):
    """Each case's answers on both ranks: the JAX server's on its data
    mesh and the port's one-process server's; the decodes carry text (or
    the head's class answers)."""
    key = f"{name}/{case}/{n}"
    want = served["jax"][key]
    assert len(want) == n and any(want)
    assert json.loads(served["one"][key]) == want
    for r in served["ranks"]:
        assert json.loads(r[key]) == want, key


@pytest.mark.parametrize("name", list(worker.SERVE_CASES))
def test_sharded_server_runs_the_chunks_of_one_process(served, name):
    """The chunks of each path (3 and 9 requests at B = 4: 1 + 3) on
    every rank, as in one process: fused on the fast path, "host" on the
    host-prompt and per-batch paths."""
    for case, kw in worker.SERVE_CASES[name]:
        key = f"{name}/{case}/chunks"
        path = ("host" if name == "head" or not kw.get("prompt_fastpath",
                                                       True) else "fused")
        want = {"fused": 0, "host": 0, path: 4}
        assert json.loads(served["one"][key]) == want
        for r in served["ranks"]:
            assert json.loads(r[key]) == want, key


@pytest.mark.parametrize("name", list(worker.SERVE_CASES))
def test_each_rank_runs_only_its_block_of_every_chunk(served, name):
    """Every chunk's step runs B / 2 = 2 rows on each rank (its data
    index's block of the chunk padded to B = 4), where one process runs
    the chunk's own rows (3, then 4, 4 and 1 of 9 requests); the staged
    tables are encoded in blocks of 2 rows a chunk of images on each
    rank."""
    for case, _ in worker.SERVE_CASES[name]:
        key = f"{name}/{case}/rows"
        assert json.loads(served["one"][key]) == [3, 4, 4, 1]
        for r in served["ranks"]:
            assert json.loads(r[key]) == [2] * 4, key
    if name != "k1":
        return
    unique = int(served["one"]["k1/staged/unique"])
    assert json.loads(served["one"]["k1/staged/rows"]) == [4, 4, 1] * 2
    assert json.loads(served["one"]["k1/staged/table_rows"]) == []
    for r in served["ranks"]:
        assert json.loads(r["k1/staged/rows"]) == [2] * 6
        tables = json.loads(r["k1/staged/table_rows"])
        assert len(tables) == 2 and tables[0] == tables[1]
        assert tables[0] == 2 * -(-unique // 4)


def test_staged_pipelined_submits_match_one_process(served):
    """Two submits over staged images (the staging tables gathered bit for
    bit), the second queued behind the first: one process's answers, and
    the second submit's are the first's reversed."""
    want = json.loads(served["one"]["k1/staged"])
    assert want[9:] == want[:9][::-1]
    assert want[:9] == served["jax"]["k1/fused/9"]
    for r in served["ranks"]:
        assert json.loads(r["k1/staged"]) == want


def test_serve_stream_gives_one_process_lines_on_every_rank(served):
    """``cli.serve_stream`` in both processes of the group: every rank
    writes the response lines of one process (and of the JAX
    ``serve_stream`` on its data mesh), the malformed request's error in
    its place."""
    want = served["one"]["k3/stream"]
    rows = [json.loads(x) for x in want.splitlines()]
    assert len(rows) == 10 and "error" in rows[3]
    assert sum("answer" in r for r in rows) == 9
    assert want == served["jax"]["k3/stream"]
    for r in served["ranks"]:
        assert r["k3/stream"] == want


def test_a_data_axis_that_does_not_divide_the_chunk_raises(served):
    """A mesh whose "data" axis does not divide ``batch_size`` is refused
    with both numbers (``build_mesh`` keeps such a mesh from the config;
    one made by hand reaches the server)."""
    exp = worker.serve_experiment(served["root"], "k1", parallelism=False)
    exp.mesh = pmesh.Mesh(3, rank=0)
    with pytest.raises(ValueError, match="data=3 does not divide the "
                                         "serving chunk batch_size=4"):
        MPRServer(exp, load_checkpoint=False)

