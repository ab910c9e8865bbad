"""The port's spans and counters (``train/profiling.py``) on a small CPU
server: off they cost a shared no-op and change no answer; on, each chunk
of each request has its queue wait and its run on the dispatcher thread,
its prepare and consume on the caller's, every span of a request carries
its id, the decode's step spans match its counters and the server's
``decode_steps``, self seconds leave the children out, the spans are
events of a running ``torch.profiler`` around the ops they launched, and a
CPU serve of each generator (T5, the LM) emits every span name that a
metric reader of the benchmark reads (a rename fails here, not silently
there).
"""

import glob
import io
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu_torch import cli as pcli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import moe_lm  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.t5 import (  # noqa: E402
    t5_greedy_decode,
    t5_spec_greedy_decode,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
    synthetic_config,
    synthetic_slake,
)
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 8  # a request: two chunks of batch_size 4
# a tiny Kimi-VL-A3B-shaped LM
LM_TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4,
               n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """A tiny fused-path experiment: batch_size 4, retrieval k 1, row
    attention, seeded random weights on the CPU."""
    splits, images = synthetic_slake(16, 8, image_size=32, seed=0,
                                     n_validate=2)
    cfg = synthetic_config(batch_size=4, epochs=1, retrieval=True, k=1,
                           image_size=32)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    cfg["t5_overrides"].update(attention_impl="row")
    root = str(tmp_path_factory.mktemp("torch_tracing"))
    return ServingExperiment(cfg, train=splits["train"],
                             validate=splits["validate"],
                             test=splits["test"], images=images,
                             device="cpu", model_root=root)


def _requests(exp, n_requests=2):
    tests = exp.splits["test"][:ROWS * n_requests]
    return [tests[i:i + ROWS] for i in range(0, len(tests), ROWS)]


def _serve(exp, traced: bool, **server_kw):
    """Two requests of two chunks through one server, both submitted
    before either is read; (answers, server, snapshot or None)."""
    server = MPRServer(exp, load_checkpoint=False, pipeline_depth=2,
                       **server_kw)
    names = [e["image_name"] for e in exp.splits["test"]]
    unique = list(dict.fromkeys(names))
    server.stage_images(np.stack([exp.images[n] for n in unique]), unique)
    profiling.enable(traced)
    steps0 = server.decode_steps
    handles = [server.submit(None, [e["question"] for e in req],
                             [e["task"] for e in req],
                             image_ids=[e["image_name"] for e in req])
               for req in _requests(exp)]
    answers = [h.result() for h in handles]
    profiling.enable(False)
    server.steps_in_window = server.decode_steps - steps0
    snap = profiling.snapshot() if traced else None
    return answers, server, snap


@pytest.fixture(scope="module")
def traced(exp):
    profiling.reset()
    answers, server, snap = _serve(exp, True)
    profiling.reset()
    return answers, server, snap


def _by_name(ring, name):
    return [r for r in ring if r["name"] == name]


def test_off_returns_the_shared_noop_and_records_nothing():
    assert not profiling.enabled()
    first, second = profiling.span("mpr.x"), profiling.span("mpr.y", a=1)
    assert first is second
    with first as inside:
        assert inside is None
    profiling.count("c")
    profiling.record("mpr.r", 1, 2)
    assert profiling.now_ns() == 0
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "counters": {}, "ring": []}


def test_answers_identical_with_tracing_on_and_off(exp, traced):
    off, _, _ = _serve(exp, False)
    assert traced[0] == off
    assert all(len(a) == ROWS for a in off)


def test_each_chunk_waits_once_and_runs_and_fetches_on_the_dispatcher(
        traced):
    _, server, snap = traced
    ring = snap["ring"]
    main = threading.get_native_id()
    chunks = _by_name(ring, "mpr.serve.chunk")
    waits = _by_name(ring, "mpr.serve.queue_wait")
    keys = sorted((r["attrs"]["request_id"], r["attrs"]["chunk"])
                  for r in chunks)
    assert keys == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert sorted((r["attrs"]["request_id"], r["attrs"]["chunk"])
                  for r in waits) == keys
    for c in chunks:
        assert c["thread"] != main and c["parent"] is None
        kids = [r for r in ring if r["parent"] == c["id"]]
        assert sorted(k["name"] for k in kids) == ["mpr.serve.fetch",
                                                   "mpr.serve.run"]
        assert all(k["thread"] == c["thread"] for k in kids)
    assert snap["spans"]["mpr.serve.chunk"]["calls"] == 4
    assert snap["counters"]["serve.chunks.fused"] == 4
    assert snap["counters"]["serve.rows"] == 2 * ROWS
    requests = _by_name(ring, "mpr.serve.request")
    assert sorted(r["attrs"]["request_id"] for r in requests) == [0, 1]


@pytest.mark.parametrize("name", ["mpr.serve.submit", "mpr.serve.prepare",
                                  "mpr.serve.consume", "mpr.serve.wait",
                                  "mpr.text.encode", "mpr.text.decode",
                                  "mpr.text.clip_tokenize"])
def test_host_work_runs_on_the_caller_thread(traced, name):
    ring = traced[2]["ring"]
    spans = _by_name(ring, name)
    assert spans
    assert {r["thread"] for r in spans} == {threading.get_native_id()}


@pytest.mark.parametrize("name", ["mpr.serve.prepare", "mpr.serve.consume"])
def test_prepare_and_consume_once_a_chunk(traced, name):
    spans = _by_name(traced[2]["ring"], name)
    assert sorted((r["attrs"]["request_id"], r["attrs"]["chunk"])
                  for r in spans) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_every_span_of_a_request_carries_its_id(traced):
    ring = traced[2]["ring"]
    by_id = {r["id"]: r for r in ring}
    for r in ring:
        assert r["attrs"].get("request_id") in (0, 1), r
        # a submit consumes older requests' chunks, which carry their own
        if r["parent"] is not None and r["name"] != "mpr.serve.consume":
            parent = by_id[r["parent"]]
            assert parent["attrs"]["request_id"] == r["attrs"]["request_id"]
            if "chunk" in parent["attrs"]:
                assert r["attrs"]["chunk"] == parent["attrs"]["chunk"]


def test_decode_steps_match_the_counters_and_the_server(traced):
    _, server, snap = traced
    ring = snap["ring"]
    steps = _by_name(ring, "mpr.t5.decode.step")
    assert len(steps) == snap["spans"]["mpr.t5.decode.step"]["calls"]
    assert len(steps) == snap["counters"]["t5.decode_steps"]
    assert len(steps) == server.steps_in_window > 0
    syncs = _by_name(ring, "mpr.t5.decode.eos_sync")
    assert sorted(s["parent"] for s in syncs) == sorted(
        s["id"] for s in steps)
    assert snap["counters"]["t5.eos_syncs"] == len(steps)
    decodes = {r["id"] for r in _by_name(ring, "mpr.t5.decode")}
    assert len(decodes) == 4
    assert {s["parent"] for s in steps} == decodes


def test_self_seconds_are_the_duration_less_the_children(traced):
    snap = traced[2]
    ring = snap["ring"]
    child_ns = {}
    for r in ring:
        if r["parent"] is not None:
            child_ns[r["parent"]] = (child_ns.get(r["parent"], 0)
                                     + r["end_ns"] - r["start_ns"])
    for name, tot in snap["spans"].items():
        mine = _by_name(ring, name)
        total = sum(r["end_ns"] - r["start_ns"] for r in mine)
        own = sum(r["end_ns"] - r["start_ns"] - child_ns.get(r["id"], 0)
                  for r in mine)
        assert tot["calls"] == len(mine)
        assert tot["total_s"] == pytest.approx(total * 1e-9, abs=1e-9)
        assert tot["self_s"] == pytest.approx(own * 1e-9, abs=1e-9)
        assert 0 <= tot["self_s"] <= tot["total_s"]


def test_self_seconds_of_nested_sleeps():
    profiling.enable()
    with profiling.span("mpr.outer"):
        time.sleep(0.02)
        with profiling.span("mpr.inner"):
            time.sleep(0.03)
    spans = profiling.snapshot()["spans"]
    outer, inner = spans["mpr.outer"], spans["mpr.inner"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert outer["self_s"] >= 0.02 and inner["self_s"] >= 0.03
    profiling.reset()
    assert profiling.snapshot()["spans"] == {}


def test_spans_of_other_threads_merge_without_a_lock():
    """More threads than cores, switching often: no span, count or id is
    lost, each thread's spans nest on its own stack."""
    n_threads, n_spans = (os.cpu_count() or 1) + 4, 200
    profiling.enable()
    # all alive at once, so no thread id is reused
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=60)
        for _ in range(n_spans):
            with profiling.span("mpr.w"):
                with profiling.span("mpr.w.inner"):
                    profiling.count("w")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot(last=10 ** 6)
    total = n_threads * n_spans
    assert snap["spans"]["mpr.w"]["calls"] == total
    assert snap["spans"]["mpr.w.inner"]["calls"] == total
    assert snap["counters"]["w"] == total
    ring = snap["ring"]
    assert len({r["id"] for r in ring}) == len(ring) == 2 * total
    by_id = {r["id"]: r for r in ring}
    for r in ring:
        if r["name"] == "mpr.w.inner":
            assert by_id[r["parent"]]["thread"] == r["thread"]
    assert len({r["thread"] for r in ring}) == n_threads


def _decode_inputs(exp):
    cfg = exp.model_cfg.t5
    g = torch.Generator().manual_seed(0)
    hidden = torch.randn(3, 5, cfg.d_model, generator=g)
    mask = torch.ones(3, 5, dtype=torch.int32)
    return exp.params.t5, cfg, hidden, mask


@pytest.mark.parametrize("spec", [False, True])
def test_each_decode_step_has_one_sync(exp, spec):
    params, cfg, hidden, mask = _decode_inputs(exp)
    profiling.enable()
    stats = {}
    if spec:
        drafts = torch.randint(2, cfg.vocab_size, (3, 8),
                               generator=torch.Generator().manual_seed(1))
        t5_spec_greedy_decode(params, cfg, hidden, mask, drafts,
                              max_new_tokens=6, block=2, stats=stats)
    else:
        t5_greedy_decode(params, cfg, hidden, mask, max_new_tokens=6)
    snap = profiling.snapshot()
    steps = snap["spans"]["mpr.t5.decode.step"]["calls"]
    assert steps == snap["counters"]["t5.decode_steps"]
    assert steps == snap["spans"]["mpr.t5.decode.eos_sync"]["calls"]
    assert steps == snap["counters"]["t5.eos_syncs"]
    assert snap["spans"]["mpr.t5.decode"]["calls"] == 1
    if spec:
        assert steps == stats["passes"]


def test_each_lm_token_has_one_sync():
    """The LM's decode checks once after the prefill's token, outside the
    steps, and once in each step, the last one included."""
    cfg = moe_lm.LMConfig(**LM_TINY)
    lm = moe_lm.MoELM(cfg, torch.Generator().manual_seed(0))
    ids = torch.randint(2, cfg.vocab_size, (3, 5),
                        generator=torch.Generator().manual_seed(1))
    profiling.enable()
    moe_lm.lm_generate(lm, cfg, None, ids, torch.ones_like(ids),
                       max_new_tokens=6)
    snap = profiling.snapshot()
    steps, counters = snap["counters"]["lm.decode_steps"], snap["counters"]
    assert steps == snap["spans"]["mpr.lm.decode.step"]["calls"] == 5
    assert counters["lm.eos_syncs"] == steps + 1
    assert snap["spans"]["mpr.lm.decode.eos_sync"]["calls"] == steps + 1
    ring = snap["ring"]
    by_id = {r["id"]: r["name"] for r in ring}
    assert sorted(by_id[s["parent"]] for s in _by_name(
        ring, "mpr.lm.decode.eos_sync")) == (
        ["mpr.lm.decode"] + ["mpr.lm.decode.step"] * steps)


def test_spans_are_profiler_events_around_their_ops(exp):
    params, cfg, hidden, mask = _decode_inputs(exp)
    profiling.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t5_greedy_decode(params, cfg, hidden, mask, max_new_tokens=3)
    events = list(prof.events())
    decode = [e for e in events if e.name == "mpr.t5.decode"]
    steps = [e for e in events if e.name == "mpr.t5.decode.step"]
    assert len(decode) == 1 and len(steps) >= 1
    assert all(s.cpu_parent is decode[0] for s in steps)
    for s in steps:
        ops = [c.name for c in s.cpu_children]
        assert any(n.startswith("aten::") for n in ops), ops
        assert "mpr.t5.decode.eos_sync" in ops
        assert s.time_range.start >= decode[0].time_range.start
        assert s.time_range.end <= decode[0].time_range.end


def _reader_span_names():
    """The ``mpr.`` names that the benchmark's metric readers read."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "portbench", "layer_metrics",
                                       "*.py")):
        with open(path) as f:
            names |= set(re.findall(r"[\"'](mpr\.[A-Za-z0-9_.]+)[\"']",
                                    f.read()))
    return sorted(names)


def _lm_serve_spans(exp, root) -> set:
    """The span names of the same serve with the LM generator
    (``LM_TINY`` in T5's place)."""
    cfg = dict(exp.cfg, generator="lm", lm_overrides=LM_TINY)
    splits = exp.splits
    lm_exp = ServingExperiment(cfg, train=splits["train"],
                               validate=splits["validate"],
                               test=splits["test"], images=exp.images,
                               device="cpu", model_root=root)
    profiling.reset()
    _, _, snap = _serve(lm_exp, True)
    profiling.reset()
    return set(snap["spans"])


def test_a_cpu_serve_emits_every_span_a_metric_reader_reads(traced, exp,
                                                             tmp_path):
    # a reader may read either generator's spans: T5's serve, then the LM's
    emitted = set(traced[2]["spans"]) | _lm_serve_spans(exp, str(tmp_path))
    read = _reader_span_names()
    assert read, "no reader reads a span of the program"
    assert not set(read) - emitted, sorted(set(read) - emitted)


def test_cli_serve_trace_writes_spans_and_a_chrome_trace(
        exp, tmp_path, monkeypatch, capsys):
    from multimodalpromptretrieval_tpu_torch.train import experiment

    monkeypatch.setattr(experiment, "run_from_config",
                        lambda *a, **kw: (exp, None))
    requests = tmp_path / "requests.jsonl"
    requests.write_text("".join(
        json.dumps({"question": e["question"], "task": e["task"],
                    "image_name": e["image_name"]}) + "\n"
        for e in exp.splits["test"][:6]))
    out = tmp_path / "trace"
    capsys.readouterr()
    pcli.main(["--serve", "--requests", str(requests), "--trace", str(out),
               "--config", "unused.json", "--device", "cpu"])
    assert len(capsys.readouterr().out.splitlines()) == 6
    assert not profiling.enabled()
    with open(out / "spans.json") as f:
        spans = json.load(f)
    assert spans["spans"]["mpr.serve.chunk"]["calls"] == 2
    assert spans["counters"]["serve.rows"] == 6
    with open(out / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mpr.serve.submit" in names


def test_cli_parser_takes_trace():
    args = pcli.build_parser().parse_args(["--serve", "--trace", "d"])
    assert args.trace == "d"
    assert pcli.build_parser().parse_args(["--serve"]).trace is None


def test_stream_is_unchanged_by_the_trace(exp, tmp_path):
    text = "".join(json.dumps({"question": e["question"], "task": e["task"],
                               "image_name": e["image_name"]}) + "\n"
                   for e in exp.splits["test"][:5])
    plain, traced = io.StringIO(), io.StringIO()
    pcli.serve_stream(exp, io.StringIO(text), plain)
    with pcli.traced(str(tmp_path)):
        pcli.serve_stream(exp, io.StringIO(text), traced)
    assert plain.getvalue() == traced.getvalue()
