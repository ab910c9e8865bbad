"""The port's entry points on disk data against the JAX package, on the CPU.

One synthetic SLAKE on disk (32-px images), one config (fp32, retrieval
k=3, row attention, dropout 0), one seeded JAX init (pad embedding zeroed,
so that the tiny model's answers carry text) bridged into the port. The JAX
``Experiment`` trains and tests; the port's ``run_from_config`` trains and
tests: per-epoch losses agree within 1e-4, and ``test()`` of both packages
on the JAX checkpoint file writes identical metrics files. ``serve_stream``
of both packages answers the JSONL streams of ``tests/test_cli_serve.py``
with identical lines, and so do they with ``--quantize int8``,
``--spec-decode 4`` and ``--length-sort``. A server built from a fresh
experiment answers from the trained checkpoint. ``cli.main`` runs
``--train``, ``--test``, ``--serve --requests`` and ``--eval --qid`` on the
CPU.
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
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import cli as pcli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    run_from_config,
)

TOL = 1e-4
ARTIFACTS = ("incorrect_ids.txt", "correct_ids.txt")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path) as f:
        return f.read()


def _losses(log_root, prefix, name):
    rows = _read(os.path.join(log_root, prefix, name)).strip().splitlines()
    return [(int(r.split(",")[0]), float(r.split(",")[1])) for r in rows[1:]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_cli"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=12,
                             n_validate=4, n_test=4, image_size=32, seed=0)
    cfg = synthetic_config(root, batch_size=8, epochs=4, image_size=32,
                           retrieval=True, k=3)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    # the corpus tokenizer's 117 ids, so that every generated id decodes
    cfg["t5_overrides"].update(attention_impl="row", dropout_rate=0.0,
                               vocab_size=128)
    # one device for the JAX package: the tests' eight virtual CPU devices
    # would shard a batch of 8 for nothing but compile time
    cfg["parallelism"] = {"data": 1}
    cfg_path = os.path.join(root, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    dirs = {n: os.path.join(root, n) for n in (
        "jax_logs", "jax_models", "port_logs", "port_models", "same_logs")}

    jexp = Experiment(copy.deepcopy(cfg), train_mode=True, quiet=True,
                      log_root=dirs["jax_logs"],
                      model_root=dirs["jax_models"])
    # a random tied head re-emits its input token, and the decode starts
    # from pad: a zero pad embedding lets the answers carry text
    jexp.params["t5"]["shared"] = jexp.params["t5"]["shared"].at[0].set(0.0)
    probe = ServingExperiment(dict(cfg, retrieval=0), device="cpu")
    params = bridge.params_from_jax(jexp.params, probe.model_cfg)

    jres = jexp.train()
    jmetrics = jexp.test()
    pexp, pres = run_from_config(cfg_path, train=True, test=True,
                                 device="cpu", params=params, quiet=True,
                                 log_root=dirs["port_logs"],
                                 model_root=dirs["port_models"])
    # the port's test() on the JAX package's checkpoint file
    pexp.model_path, pexp.log_root = jexp.model_path, dirs["same_logs"]
    same = pexp.test()
    return dict(root=root, cfg=cfg, cfg_path=cfg_path, dirs=dirs, jexp=jexp,
                pexp=pexp, jres=jres, pres=pres, jmetrics=jmetrics,
                same=same)


@pytest.mark.parametrize("name", ["training_loss.txt",
                                  "validation_loss.txt"])
def test_epoch_losses_match_jax(runs, name):
    prefix = runs["jexp"].model_prefix
    want = _losses(runs["dirs"]["jax_logs"], prefix, name)
    got = _losses(runs["dirs"]["port_logs"], prefix, name)
    assert len(got) == len(want) == runs["cfg"]["hyperparameters"]["epochs"]
    assert [u for u, _ in got] == [u for u, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want],
                               atol=TOL, rtol=0)
    assert runs["pres"]["train"]["best_epoch"] == runs["jres"]["best_epoch"]


def test_test_on_one_checkpoint_writes_the_jax_files(runs):
    """Both packages' test() on the same checkpoint file: identical
    performance.txt, id files and report (the retrieval diagnostics
    included)."""
    prefix = runs["jexp"].model_prefix
    jdir, pdir = runs["dirs"]["jax_logs"], runs["dirs"]["same_logs"]
    for name in ARTIFACTS + (prefix + "performance.txt",):
        assert _read(os.path.join(pdir, name)) == \
            _read(os.path.join(jdir, name)), name
    assert runs["same"].report() == runs["jmetrics"].report()
    assert runs["same"].predictions == runs["jmetrics"].predictions
    assert any(runs["same"].predictions.values())  # the answers carry text
    assert "retrieved answers" in runs["same"].report()


def test_run_from_config_tests_its_own_checkpoint(runs):
    pdir = runs["dirs"]["port_logs"]
    prefix = runs["pexp"].model_prefix
    assert os.path.exists(os.path.join(runs["dirs"]["port_models"],
                                       prefix + ".npz"))
    perf = _read(os.path.join(pdir, prefix + "performance.txt"))
    assert perf.splitlines()[-1].startswith("Overall,")
    assert runs["pres"]["test"].overall == pytest.approx(
        float(perf.splitlines()[-1].split(",")[1]), abs=1e-4)


def _stream_requests(exp, kind):
    """The request streams of ``tests/test_cli_serve.py``."""
    entries = (exp.splits["test"] * 3)[:19]  # crosses the batch of 8
    reqs = [{"question": e["question"], "task": e["task"],
             "image_name": e["image_name"]} for e in entries]
    if kind == "batches":
        return [json.dumps(r) for r in reqs]
    e = exp.splits["test"][0]
    if kind == "image_path":
        path = os.path.join(exp.cfg["datafolder"], "SLAKE", "imgs",
                            e["image_name"])
        return [json.dumps({"question": e["question"], "task": e["task"],
                            "image": path}), json.dumps(reqs[0])]
    if kind == "no_image":
        return [json.dumps({"question": "?"})]
    lines = [json.dumps(r) for r in reqs[:6]]
    lines.insert(1, "{not json")
    lines.insert(3, json.dumps({"question": "q?", "task": "open",
                                "image_name": "no-such-image.png"}))
    lines.insert(4, json.dumps({"task": "open",
                                "image_name": e["image_name"]}))
    lines.append("42")
    return lines


STREAMS = ("batches", "image_path", "no_image", "bad_requests")


@pytest.fixture(scope="module")
def streams(runs):
    """The four streams, one after the other in one JSONL stream, through
    both packages' ``serve_stream`` (responses come in request order, so
    each stream's lines are a slice of the output). Both servers load the
    JAX checkpoint: the port's experiment points at it since the
    same-checkpoint test."""
    parts = {k: _stream_requests(runs["pexp"], k) for k in STREAMS}
    text = "".join(line + "\n" for k in STREAMS for line in parts[k])
    out = {}
    for name, mod, exp in (("jax", jcli, runs["jexp"]),
                           ("port", pcli, runs["pexp"])):
        buf = io.StringIO()
        n = mod.serve_stream(exp, io.StringIO(text), buf)
        lines = buf.getvalue().splitlines()
        assert n == len(lines)
        out[name] = {}
        for k in STREAMS:
            out[name][k], lines = (lines[:len(parts[k])],
                                   lines[len(parts[k]):])
        assert lines == []
    return parts, out


@pytest.mark.parametrize("kind", STREAMS)
def test_serve_stream_lines_match_jax(streams, kind):
    parts, out = streams
    got, want = out["port"][kind], out["jax"][kind]
    assert len(got) == len(parts[kind])
    assert got == want
    rows = [json.loads(x) for x in got]
    if kind == "image_path":  # the file answers as its cached image does
        assert rows[0] == rows[1] and "answer" in rows[0]
    if kind == "no_image":
        assert "image" in rows[0]["error"]
    if kind == "bad_requests":
        assert {i for i, r in enumerate(rows) if "error" in r} == \
            {1, 3, 4, len(got) - 1}


def test_server_of_a_fresh_experiment_loads_the_trained_checkpoint(runs):
    """A server built after train() from a NEW experiment (seed weights)
    answers as the trained weights do."""
    cfg, pexp = runs["cfg"], runs["pexp"]
    trained_path = os.path.join(runs["dirs"]["port_models"],
                                pexp.model_prefix + ".npz")
    fresh = ServingExperiment(copy.deepcopy(cfg), device="cpu",
                              model_root=runs["dirs"]["port_models"])
    assert fresh.model_path == trained_path
    seed_shared = fresh.params.t5.shared.detach().clone()
    entries = fresh.splits["test"]
    ask = (None, [e["question"] for e in entries],
           [e["task"] for e in entries], [e["image_name"] for e in entries])
    images = np.stack([fresh.images[n] for n in ask[3]])
    seed_answers = MPRServer(fresh, load_checkpoint=False).answer(
        images, *ask[1:3], image_ids=ask[3])
    loaded = MPRServer(fresh).answer(images, *ask[1:3], image_ids=ask[3])

    in_memory = ServingExperiment(copy.deepcopy(cfg), device="cpu",
                                  model_file=os.path.join(
                                      runs["root"], "missing.npz"))
    params, _, _ = checkpoint.load_checkpoint(trained_path,
                                              in_memory.model_cfg)
    in_memory.params = params
    want = MPRServer(in_memory, load_checkpoint=False).answer(
        images, *ask[1:3], image_ids=ask[3])
    assert loaded == want
    assert not torch.equal(fresh.params.t5.shared, seed_shared)
    torch.testing.assert_close(fresh.params.t5.shared, params.t5.shared,
                               rtol=0, atol=0)
    assert loaded != seed_answers


def test_main_trains_tests_and_serves_on_the_cpu(runs, tmp_path,
                                                 monkeypatch, capsys):
    """``main`` with ``--device cpu``: ``--train`` writes the checkpoint
    under ``models/`` of the working directory; a second run ``--test
    --serve --requests`` loads it and answers every request in order."""
    cfg = copy.deepcopy(runs["cfg"])
    cfg["hyperparameters"]["epochs"] = 1
    cfg["retrieval_cache_dir"] = str(tmp_path / "cache")
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    requests = str(tmp_path / "requests.jsonl")
    lines = _stream_requests(runs["pexp"], "bad_requests")
    with open(requests, "w") as f:
        f.write("\n".join(lines) + "\n")
    monkeypatch.chdir(tmp_path)
    pcli.main(["--train", "--config", path, "--device", "cpu"])
    prefix = runs["pexp"].model_prefix
    assert os.path.exists(os.path.join("models", prefix + ".npz"))
    assert os.listdir(tmp_path / "cache")  # the content-keyed index
    capsys.readouterr()
    pcli.main(["--test", "--serve", "--requests", requests, "--config",
               path, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "Overall accuracy" in "\n".join(out)
    rows = [json.loads(x) for x in out[-len(lines):]]
    assert [("error" in r) for r in rows] == [
        i in (1, 3, 4, len(lines) - 1) for i in range(len(lines))]
    assert os.path.exists(os.path.join("logs", prefix + "performance.txt"))


@pytest.mark.parametrize("flag", [["--quantize", "int8"],
                                  ["--spec-decode", "4"], ["--length-sort"],
                                  ["--eval"]])
def test_unported_flags_raise(runs, streams, tmp_path, monkeypatch, capsys,
                              flag):
    """No flag raises any more. ``--eval --qid`` (ROADMAP A7, ported)
    loads the trained checkpoint and writes the attention figure of every
    (layer, head) of the question. The three serving flags reach the server
    through ``main``: the lines of ``--serve --requests`` equal the JAX
    ``serve_stream``'s with the same option, and, for the two options that
    keep the answers, the lines without it."""
    from multimodalpromptretrieval_tpu_torch.train import experiment
    monkeypatch.setattr(experiment, "run_from_config",
                        lambda *a, **kw: (runs["pexp"], None))
    if flag == ["--eval"]:
        monkeypatch.chdir(tmp_path)
        qid = runs["pexp"].splits["test"][0]["question_id"]
        pcli.main(["--eval", "--qid", qid, "--config", "unused.json",
                   "--device", "cpu"])
        t5 = runs["pexp"].model_cfg.t5
        assert sorted(os.path.relpath(os.path.join(d, f), "figures")
                      for d, _, fs in os.walk("figures") for f in fs) == \
            sorted(os.path.join(qid, f"head{j}", f"attention{i}.pdf")
                   for i in range(t5.num_decoder_layers)
                   for j in range(t5.num_heads))
        return
    args = pcli.build_parser().parse_args(flag)
    options = dict(quantize=args.quantize, spec_decode=args.spec_decode,
                   length_sort=args.length_sort)
    parts, out = streams
    requests = str(tmp_path / "requests.jsonl")
    with open(requests, "w") as f:
        f.write("".join(line + "\n" for line in parts["batches"]))
    buf = io.StringIO()
    with open(requests) as f:
        jcli.serve_stream(runs["jexp"], f, buf, **options)
    want = buf.getvalue().splitlines()
    # main on the trained experiment: the stream goes to stdout
    capsys.readouterr()
    pcli.main(["--serve", "--requests", requests, "--config", "unused.json",
               "--device", "cpu", *flag])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(parts["batches"]) and got == want
    if args.quantize is None:
        assert got == out["port"]["batches"]
