"""The PyTorch port's serving path against the JAX package, on the CPU.

One tiny synthetic SLAKE setup feeds the JAX ``Experiment`` + ``MPRServer``
and the port's ``ServingExperiment`` + ``MPRServer``, with the weights
crossing through ``bridge.params_from_jax``: the retrieval index, the
fused-path answers and the host-path answers must agree (answer strings
identical at fp32), on the row paths and with the flash-attention / K6
overrides, and with length-sorted chunks. ``submit`` returns while its
chunks still run, and a failed chunk's error is raised. A subprocess shows
the port serves without jax and without the JAX package; the port's own
copies of the tokenizers are held to the JAX package's; an entry point
without a ``device`` asks for the card.
"""

import copy
import glob
import json
import os
import re
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.retrieval import hints as jhints  # noqa: E402
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import serve as pserve  # noqa: E402
from multimodalpromptretrieval_tpu_torch import serving as pserving  # noqa: E402
from multimodalpromptretrieval_tpu_torch.retrieval import (  # noqa: E402
    hints as phints,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(root, k):
    cfg = synthetic_config(root, batch_size=4, epochs=1, image_size=32,
                           retrieval=True, k=k)
    cfg["clip_overrides"]["patch_size"] = 16
    cfg["clip_overrides"]["attention_impl"] = "row"
    # the vocabulary of the corpus-built tokenizer (117 ids), so that every
    # generated id decodes to text; row attention on the JAX side too
    cfg["t5_overrides"].update(vocab_size=117, attention_impl="row")
    cfg["cache_retrieval"] = False
    return cfg


def _pair(root, cfg, port_cfg=None):
    """(JAX Experiment, port ServingExperiment) on one synthetic corpus with
    the same weights; ``port_cfg`` (default ``cfg``) is the port's config."""
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=16,
                             n_validate=8, n_test=8, image_size=32, seed=0)
    port_cfg = cfg if port_cfg is None else port_cfg
    jexp = Experiment(cfg, train_mode=False, quiet=True,
                      log_root=os.path.join(root, "logs"),
                      model_root=os.path.join(root, "models"))
    # a random tied head re-emits its input token, and the decode starts
    # from pad: zero the pad embedding so the answers carry text
    shared = jexp.params["t5"]["shared"]
    jexp.params["t5"]["shared"] = shared.at[0].set(0.0)
    splits = dict(train=jexp.dataset_train.entries,
                  validate=jexp.dataset_validate.entries,
                  test=jexp.dataset_test.entries, images=jexp.images)
    # the same config parsed by the port, then the JAX weights bridged in
    model_cfg = ServingExperiment(dict(port_cfg, retrieval=0), device="cpu",
                                  **splits).model_cfg
    params = bridge.params_from_jax(jexp.params, model_cfg)
    return jexp, ServingExperiment(port_cfg, params=params, device="cpu",
                                   **splits)


@pytest.fixture(scope="module", params=[1, 3])
def pair(tmp_path_factory, request):
    k = request.param
    root = str(tmp_path_factory.mktemp(f"torch_serve{k}"))
    return _pair(root, _config(root, k))


@pytest.fixture(scope="module")
def pallas_pair(tmp_path_factory):
    """The overrides of the smoke run's second path: flash attention in
    both towers and the T5 encoder, decode_attention_impl "pallas" (K6).
    JAX runs its flash kernel as "pallas_interpret" on the CPU."""
    root = str(tmp_path_factory.mktemp("torch_serve_pallas"))
    cfg = _config(root, 3)
    port_cfg = copy.deepcopy(cfg)
    cfg["t5_overrides"].update(attention_impl="pallas_interpret",
                               decode_attention_impl="pallas")
    cfg["clip_overrides"]["attention_impl"] = "pallas_interpret"
    port_cfg["t5_overrides"].update(attention_impl="pallas",
                                    decode_attention_impl="pallas")
    port_cfg["clip_overrides"]["attention_impl"] = "pallas"
    return _pair(root, cfg, port_cfg)


def _requests(jexp):
    entries = (jexp.dataset_test.entries * 2)[:9]
    images = np.stack([jexp.images[e["image_name"]] for e in entries])
    return (images, [e["question"] for e in entries],
            [e["task"] for e in entries], [e["image_name"] for e in entries])


def test_tokenizers_and_index_match_jax(pair):
    jexp, pexp = pair
    texts = [e["question"] + " " + e["answer"]
             for e in jexp.dataset_test.entries]
    assert [jexp.tokenizer.encode(t) for t in texts] == \
        [pexp.tokenizer.encode(t) for t in texts]
    np.testing.assert_allclose(
        pexp.retrieval_index.embeddings.numpy(),
        np.asarray(jexp.retrieval_index.embeddings), atol=1e-5, rtol=0)
    assert pexp.retrieval_index.answers == jexp.retrieval_index.answers


def test_server_answers_match_jax(pair):
    """Fused path (port) == fused path (JAX) == host path (port)."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    want = JServer(jexp, load_checkpoint=False).answer(
        images, questions, tasks, image_ids=ids)
    fast = MPRServer(pexp, load_checkpoint=False)
    got = fast.answer(images, questions, tasks, image_ids=ids)
    host = MPRServer(pexp, load_checkpoint=False, prompt_fastpath=False)
    got_host = host.answer(images, questions, tasks, image_ids=ids)
    assert got == want
    assert got_host == want
    assert fast.chunks == {"fused": 3, "host": 0}
    assert host.chunks == {"fused": 0, "host": 3}
    assert any(a for a in got)  # the decode produced text


def test_server_answers_match_jax_with_pallas_overrides(pallas_pair):
    """The port reads the overrides into its config and serves the JAX
    answers through the flash-attention towers and encoder and K6."""
    jexp, pexp = pallas_pair
    mcfg = pexp.model_cfg
    assert (mcfg.t5.attention_impl, mcfg.t5.decode_attention_impl,
            mcfg.clip.attention_impl) == ("pallas", "pallas", "pallas")
    images, questions, tasks, ids = _requests(jexp)
    want = JServer(jexp, load_checkpoint=False).answer(
        images, questions, tasks, image_ids=ids)
    server = MPRServer(pexp, load_checkpoint=False)
    got = server.answer(images, questions, tasks, image_ids=ids)
    assert got == want
    assert server.chunks == {"fused": 3, "host": 0}
    assert any(a for a in got)
    np.testing.assert_allclose(
        pexp.retrieval_index.embeddings.numpy(),
        np.asarray(jexp.retrieval_index.embeddings), atol=1e-5, rtol=0)


def test_staged_pipelined_submits_match_answer(pair):
    """Two submits, the second queued behind the first (pipeline depth 1),
    over staged images: same answers as one-shot calls."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    server = MPRServer(pexp, load_checkpoint=False)
    server.stage_images(images, ids)
    h1 = server.submit(None, questions, tasks, image_ids=ids)
    h2 = server.submit(None, questions[::-1], tasks[::-1],
                       image_ids=ids[::-1])
    assert not h2.done()
    second, first = h2.result(), h1.result()
    assert h1.done() and h2.done()
    assert first == MPRServer(pexp, load_checkpoint=False).answer(
        images, questions, tasks, image_ids=ids)
    assert second == first[::-1]


def test_length_sorted_answers_match_unsorted_and_jax(pair):
    """``length_sort=True`` re-chunks the 9 requests (3 chunks of 4) by
    predicted answer length; the answers come back in the caller's order,
    equal to the unsorted server's and to the JAX server's."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    want = JServer(jexp, load_checkpoint=False, length_sort=True).answer(
        images, questions, tasks, image_ids=ids)
    server = MPRServer(pexp, load_checkpoint=False, length_sort=True)
    handle = server.submit(images, questions, tasks, image_ids=ids)
    perm = handle._perm
    got = handle.result()
    assert sorted(perm) == list(range(len(questions)))
    assert handle._perm is None  # unsorted exactly once
    assert got == want
    assert got == MPRServer(pexp, load_checkpoint=False).answer(
        images, questions, tasks, image_ids=ids)
    assert server.chunks == {"fused": 3, "host": 0}


@pytest.mark.parametrize("depth", [1, 2])
def test_submit_returns_while_its_chunks_run(pair, monkeypatch, depth):
    """F3: with every chunk's step held on an event, ``submit`` of
    ``depth`` chunks returns before any step has run (the step waits at
    most 3 s, so a ``submit`` that runs its chunks itself returns late,
    with the steps done); ``result()`` after the release gives the serial
    answers."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    n = depth * pexp.batch_size
    ask = (images[:n], questions[:n], tasks[:n])
    serial = MPRServer(pexp, load_checkpoint=False).answer(
        *ask, image_ids=ids[:n])
    release, ran = threading.Event(), []
    step = pserve.fused_serve_step

    def held(*args, **kw):
        release.wait(3)
        out = step(*args, **kw)
        ran.append(threading.current_thread().name)
        return out

    monkeypatch.setattr(pserve, "fused_serve_step", held)
    server = MPRServer(pexp, load_checkpoint=False, pipeline_depth=depth)
    handle = server.submit(*ask, image_ids=ids[:n])
    assert ran == [] and not handle.done()
    release.set()
    assert handle.result() == serial
    assert len(ran) == depth and threading.current_thread().name not in ran


def test_a_failed_chunk_raises_from_result_and_next_submit(pair,
                                                           monkeypatch):
    """A chunk's error is raised by its handle's ``result()``; one that no
    ``result()`` has read yet is raised by the next ``submit``. The server
    serves on afterwards."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    ask = (images[:4], questions[:4], tasks[:4])
    want = MPRServer(pexp, load_checkpoint=False).answer(*ask,
                                                          image_ids=ids[:4])

    def broken(*args, **kw):
        raise RuntimeError("chunk failed")

    server = MPRServer(pexp, load_checkpoint=False)
    monkeypatch.setattr(pserve, "fused_serve_step", broken)
    handle = server.submit(*ask, image_ids=ids[:4])
    with pytest.raises(RuntimeError, match="chunk failed"):
        handle.result()
    server.submit(*ask, image_ids=ids[:4])
    server._dispatcher.submit(lambda: None).result()  # the FIFO has run
    with pytest.raises(RuntimeError, match="chunk failed"):
        server.submit(*ask, image_ids=ids[:4])
    monkeypatch.undo()
    assert server.answer(*ask, image_ids=ids[:4]) == want


def test_unsafe_question_takes_host_path(pair):
    """A trailing-whitespace question breaks the boundary contract: the
    whole call goes through the host path, with the JAX answers."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    questions = list(questions)
    questions[2] += " "
    server = MPRServer(pexp, load_checkpoint=False)
    got = server.answer(images, questions, tasks, image_ids=ids)
    assert server.chunks["fused"] == 0 and server.chunks["host"] == 3
    assert got == JServer(jexp, load_checkpoint=False).answer(
        images, questions, tasks, image_ids=ids)


@pytest.mark.parametrize("k", [1, 2, 5, 15])
def test_vote_rows_and_splice_match_jax(k):
    rng = np.random.default_rng(k)
    aid_k = rng.integers(0, 6, size=(64, k)).astype(np.int32)
    for quant in (True, False):
        np.testing.assert_array_equal(
            phints.vote_rows(torch.from_numpy(aid_k), quant).numpy(),
            np.asarray(jhints.vote_rows(jnp.asarray(aid_k), quant)))
    W = 24
    q_len = rng.integers(1, W + 1, size=16).astype(np.int32)
    h_len = rng.integers(1, 7, size=16).astype(np.int32)
    q_ids = rng.integers(2, 50, size=(16, W)).astype(np.int32)
    q_ids[np.arange(W)[None, :] >= q_len[:, None]] = 0
    h_ids = rng.integers(2, 50, size=(16, 6)).astype(np.int32)
    got = phints.splice_hints(*map(torch.from_numpy,
                                   (q_ids, q_len, h_ids, h_len)), 1)
    want = jhints.splice_hints(q_ids, q_len, h_ids, h_len, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(batch_size=512, epochs=1, retrieval=True, k=1, image_size=224),
    dict(batch_size=4, retrieval=True, k=15, use_image_info=False,
         image_size=32),
])
def test_synthetic_config_matches_jax(kw):
    want = synthetic_config("unused", **kw)
    for path_key in ("datafolder", "retrieval_cache_dir"):
        del want[path_key]
    assert pserving.synthetic_config(**kw) == want


_JAX_FREE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now fails
    sys.modules["multimodalpromptretrieval_tpu"] = None  # and of the package
    import numpy as np
    import multimodalpromptretrieval_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        if not m.name.endswith("_norm_triton"):  # imports triton, by design
            importlib.import_module(m.name)
    from multimodalpromptretrieval_tpu_torch.serve import MPRServer
    from multimodalpromptretrieval_tpu_torch.serving import (
        ServingExperiment, synthetic_config, synthetic_slake)

    splits, images = synthetic_slake(6, 3, image_size=32, seed=1)
    cfg = synthetic_config(batch_size=4, retrieval=True, k=3, image_size=32)
    cfg["clip_overrides"]["patch_size"] = 16
    exp = ServingExperiment(cfg, train=splits["train"], test=splits["test"],
                            images=images, device="cpu")
    server = MPRServer(exp, load_checkpoint=False)
    entries = splits["test"]
    names = [e["image_name"] for e in entries]
    answers = server.answer(np.stack([images[n] for n in names]),
                            [e["question"] for e in entries],
                            [e["task"] for e in entries], image_ids=names)
    assert len(answers) == len(entries) and server.chunks["fused"] == 3
    ban = ServingExperiment(dict(cfg, use_prediction_head=1, use_BAN=1),
                            train=splits["train"], test=splits["test"],
                            images=images, device="cpu")
    answers = MPRServer(ban, load_checkpoint=False).answer(
        np.stack([images[n] for n in names]),
        [e["question"] for e in entries], [e["task"] for e in entries])
    assert set(answers) <= set(ban.label2ans.values())

    # the command line on a dataset on disk: train, test, then serve
    import json, os, tempfile
    from multimodalpromptretrieval_tpu_torch import cli
    from multimodalpromptretrieval_tpu_torch.data import synthetic
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        synthetic.generate_synthetic_slake(
            os.path.join(root, "SLAKE"), n_train=6, n_validate=2, n_test=2,
            image_size=32, seed=1)
        cfg = synthetic.synthetic_config(root, batch_size=4, epochs=1,
                                         retrieval=True, image_size=32)
        with open("cfg.json", "w") as f:
            json.dump(cfg, f)
        with open("requests.jsonl", "w") as f:
            f.write(json.dumps({"question": "what shape is shown?",
                                "image_name": "synthetic_00008.png"}) + "\\n")
        cli.main(["--train", "--test", "--serve", "--requests",
                  "requests.jsonl", "--config", "cfg.json", "--device",
                  "cpu"])
        assert os.listdir("models") and os.listdir("logs")
    del sys.modules["jax"], sys.modules["multimodalpromptretrieval_tpu"]
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "multimodalpromptretrieval_tpu")]
    print("JAX_MODULES", loaded)
""")


def test_port_serves_without_jax():
    """Every module of the port imports, a tiny request is served, and the
    command line trains, tests and serves on a dataset on disk, with
    neither ``jax`` nor the JAX package importable or loaded."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _JAX_FREE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout


def test_port_sources_name_no_jax_import():
    """No ``import`` / ``from`` line of the port or of ``chip_smoke.py``
    names jax or the JAX package."""
    files = glob.glob(os.path.join(
        REPO, "multimodalpromptretrieval_tpu_torch", "**", "*.py"),
        recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    for module in ("cli.py", "ops/image.py", "data/images.py",
                   "data/datasets.py", "train/metrics.py", "models/ban.py",
                   "data/roco_questions.py"):
        assert os.path.join(REPO, "multimodalpromptretrieval_tpu_torch",
                            module) in files
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|multimodalpromptretrieval_tpu)(\.|\s|$)")
    hits = [f"{os.path.relpath(f, REPO)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(open(f), 1)
            if bad.match(line)]
    assert hits == []


def test_copied_tokenizers_match_jax(pair):
    """The port's own ``text/`` and ``native/`` give the JAX package's ids
    on the synthetic corpus, through the native and the Python paths."""
    from multimodalpromptretrieval_tpu import text as jtext
    from multimodalpromptretrieval_tpu_torch import text as ptext

    jexp, pexp = pair
    assert type(pexp.tokenizer).__module__.startswith(
        "multimodalpromptretrieval_tpu_torch.")
    entries = (jexp.dataset_train.entries + jexp.dataset_validate.entries
               + jexp.dataset_test.entries)
    texts = sorted({t for e in entries for t in (
        e["question"], e["answer"],
        f"Answer the {e['task']} question: {e['question']}")})
    corpus = pserving.tokenizer_corpus(jexp.dataset_train.entries,
                                       jexp.dataset_validate.entries,
                                       jexp.dataset_test.entries)
    for native in (True, False):
        jt = jtext.T5SentencePieceTokenizer.from_corpus(corpus)
        pt = ptext.T5SentencePieceTokenizer.from_corpus(corpus)
        jc = jtext.CLIPBPETokenizer.build_toy(context_length=32)
        pc = ptext.CLIPBPETokenizer.build_toy(context_length=32)
        if native:
            assert pt._native is not None and pc._native.available
        else:  # the pure-Python encoders
            jt._native = pt._native = None
            jc._native._handle = pc._native._handle = None
        assert [pt.encode(t) for t in texts] == [jt.encode(t) for t in texts]
        rows, lens = pt.encode_rows(texts)
        jrows, jlens = jt.encode_rows(texts)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(lens, jlens)
        np.testing.assert_array_equal(pc.tokenize(texts), jc.tokenize(texts))
        ids = pt.encode(texts[0])
        assert pt.decode(ids, skip_special_tokens=True) == \
            jt.decode(ids, skip_special_tokens=True)


def test_entry_points_without_device_ask_for_the_card(pair, tmp_path):
    """``device=None`` means the card: without CUDA the entry points raise
    and name the problem; building blocks keep their explicit device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: device=None runs on it")
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        TrainingExperiment,
    )

    _, pexp = pair
    kw = dict(train=pexp.splits["train"], images=pexp.images,
              params=pexp.params)
    cfg = dict(pexp.cfg, retrieval=0)
    for entry in (ServingExperiment, TrainingExperiment):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(cfg, **kw)
        assert entry(cfg, device="cpu", **kw).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        pserving.north_star_setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        pserving.resolve_device(None)
    # the command line and run_from_config, on a config from disk
    from multimodalpromptretrieval_tpu_torch import cli
    from multimodalpromptretrieval_tpu_torch.train.experiment import (
        run_from_config,
    )

    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(pexp.cfg, f)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_from_config(path, test=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--test", "--config", path])


def test_server_loads_the_checkpoint_at_model_path(pair, tmp_path):
    """``MPRServer(exp)`` answers from ``exp.model_path`` when the file
    exists (the JAX server's ``load_checkpoint=True``, its second
    argument); ``load_checkpoint=False`` keeps the experiment's weights."""
    from multimodalpromptretrieval_tpu_torch.train import checkpoint

    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    trained = copy.deepcopy(pexp.params)
    with torch.no_grad():
        trained.t5.shared.mul_(1.5)
    path = str(tmp_path / "trained.npz")
    checkpoint.save_checkpoint(path, trained, pexp.model_cfg)
    want = MPRServer(ServingExperiment(
        pexp.cfg, params=trained, device="cpu", **_splits(pexp)),
        False).answer(images, questions, tasks, image_ids=ids)
    exp = ServingExperiment(pexp.cfg, params=pexp.params, device="cpu",
                            model_file=path, **_splits(pexp))
    assert exp.model_path == path
    kept = MPRServer(exp, False)
    assert torch.equal(exp.params.t5.shared, pexp.params.t5.shared)
    server = MPRServer(exp)
    assert torch.equal(exp.params.t5.shared, trained.t5.shared)
    assert server.answer(images, questions, tasks, image_ids=ids) == want
    assert kept.max_new_tokens == server.max_new_tokens == 20
    assert ServingExperiment(pexp.cfg, device="cpu", model_root=str(
        tmp_path), **_splits(pexp)).model_path == str(
            tmp_path / (pexp.model_prefix + ".npz"))


def _splits(exp):
    return dict(train=exp.splits["train"], validate=exp.splits["validate"],
                test=exp.splits["test"], images=exp.images)
