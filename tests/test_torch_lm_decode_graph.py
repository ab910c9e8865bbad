"""The LM's greedy decode as captured segments (``models/moe_lm.py``: CUDA
graphs of the kernel chains between a step's K11, router, expert and head
calls) against its plain loop.

Every scenario runs twice. ``emulated`` (the CPU): a stand-in graph
re-runs its segment into the outputs it kept at capture, with the
capture's writes to the decode state undone, so the graph path's fixed
buffers, key cache, capture order and device column run on CPU tensors.
``card`` (marked ``cuda``, skipped without one): the real graphs on the
card. Both are held to the plain loop on the same device: greedy ids
identical, each step's LM-head logits and each MoE layer's routes
bit-equal, on a tiny LM with a dense first layer, 8 experts, 2 a token and
1 shared, in fp32 and bf16; rows of different prompt lengths (left
padding); two prompt widths alternating (two keys); new weight tensors (a
recapture); and stand-in wrappers on ``moe.route``, ``moe.moe_experts``,
``mla.mla_decode_attention`` and ``moe_lm.lm_head`` that see every call of
every step. The card also runs a 4-layer cut of the LM at the benchmark
cell's widths and shapes (B 512, T 133). On CPU tensors the plain loop runs
and the graph counters stay 0.
"""

import io
import json

import pytest

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

from multimodalpromptretrieval_tpu_torch.models import moe_lm  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    graphs,
    mla,
    moe,
)
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402

# K11 in bf16 takes a latent width of 512 and a rope width a multiple of
# 32, K10 widths that are multiples of 64
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
            n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=512,
            qk_nope_head_dim=16, qk_rope_head_dim=32, v_head_dim=16,
            init_std=0.1)
STEPS = 6
COUNTERS = ("lm.decode_steps", "lm.decode_graph_steps",
            "lm.decode_graph_captures")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    """No key kept from another test (its weights' addresses may come
    back), the program's counters on and cleared."""
    graphs.KEYS.clear()
    profiling.enable()
    profiling.reset()
    yield
    graphs.KEYS.clear()
    profiling.enable(False)
    profiling.reset()


class _EmulatedGraph:
    """A segment "captured" on the CPU: run once for its outputs with the
    decode state it wrote put back (a capture launches nothing), then
    re-run at each replay into those same outputs (a replay rewrites them
    in place)."""

    def __init__(self, pool, stream):
        pass

    def capture(self, fn, *args):
        kept = [(t, t.clone()) for a in args
                if isinstance(a, moe_lm.DecodeState)
                for t in (a.cache, a.lengths, a.column)]
        self.fn, self.args = fn, args
        self.out = fn(*args)
        for t, saved in kept:
            t.copy_(saved)
        return self.out

    def replay(self):
        new = self.fn(*self.args)
        pairs = (zip(self.out, new) if isinstance(self.out, tuple)
                 else [(self.out, new)])
        with torch.inference_mode():
            for held, value in pairs:
                if held is not value:
                    held.copy_(value)
        return self.out


@pytest.fixture(params=["emulated",
                        pytest.param("card", marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    """The device of the graph path: the CPU with emulated graphs, or the
    card."""
    if request.param == "card":
        return _card()
    _emulate(monkeypatch)
    return torch.device("cpu")


def _emulate(monkeypatch) -> None:
    """CPU tensors take the graph path, with :class:`_EmulatedGraph`."""
    monkeypatch.setattr(graphs, "Graph", _EmulatedGraph)
    monkeypatch.setattr(graphs, "use_graphs", lambda dev, tp: tp is None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lm(device, dtype=torch.float32, seed=0, **kw):
    cfg = moe_lm.LMConfig(**{**TINY, **kw})
    lm = moe_lm.MoELM(cfg, torch.Generator().manual_seed(seed))
    return cfg, moe_lm.hold_in(lm.to(device), dtype)


def _inputs(cfg, device, dtype=torch.float32, B=4, P=3, W=7, seed=1):
    """A prefix and right-padded prompts of B different lengths (one of
    them W, one of them 1)."""
    g = torch.Generator().manual_seed(seed)
    prefix = torch.randn((B, P, cfg.hidden_size), generator=g)
    ids = torch.zeros((B, W), dtype=torch.long)
    mask = torch.zeros((B, W), dtype=torch.long)
    lens = [W, 1] + torch.randint(1, W + 1, (B - 2,), generator=g).tolist()
    for b, n in enumerate(lens):
        ids[b, :n] = torch.randint(2, cfg.vocab_size, (n,), generator=g)
        mask[b, :n] = 1
    return prefix.to(device, dtype), ids.to(device), mask.to(device)


def _generate(monkeypatch, lm, cfg, inputs, *, plain=False, steps=STEPS,
              mode=torch.inference_mode):
    """(ids, what the wrappers saw, counters of this call); ``plain``: the
    plain loop on the same device. The wrappers keep each LM-head call's
    logits, each router call's experts, each K11 call's ``key_ok`` and
    ``length`` and count the expert calls, as the benchmark's do."""
    seen = {"logits": [], "routes": [], "k11": [], "experts": 0}
    head, route = moe_lm.lm_head, moe.route
    experts, attend = moe.moe_experts, mla.mla_decode_attention

    def lm_head(x, weight):
        y = head(x, weight)
        seen["logits"].append(y.clone())
        return y

    def route_(h, *a, **kw):
        idx, w = route(h, *a, **kw)
        seen["routes"].append(idx.clone())
        return idx, w

    def moe_experts(h, idx, w, gate_up, down):
        seen["experts"] += 1
        return experts(h, idx, w, gate_up, down)

    def mla_decode(q_lat, q_pe, cache, key_ok, length, scale):
        seen["k11"].append((key_ok, length))
        return attend(q_lat, q_pe, cache, key_ok, int(length), scale)

    with monkeypatch.context() as m:
        m.setattr(moe_lm, "lm_head", lm_head)
        m.setattr(moe, "route", route_)
        m.setattr(moe, "moe_experts", moe_experts)
        m.setattr(mla, "mla_decode_attention", mla_decode)
        if plain:
            m.setattr(graphs, "use_graphs", lambda dev, tp: False)
        before = dict(profiling.snapshot()["counters"])
        with mode():
            ids = moe_lm.lm_generate(lm, cfg, *inputs, max_new_tokens=steps)
        after = profiling.snapshot()["counters"]
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    return ids, seen, counts


def _same(got, want):
    ids, seen, counts = got
    ids0, seen0, counts0 = want
    assert torch.equal(ids.cpu(), ids0.cpu())
    assert counts["lm.decode_steps"] == counts0["lm.decode_steps"]
    assert len(seen["logits"]) == len(seen0["logits"]) \
        == 1 + counts0["lm.decode_steps"]
    for t, (a, b) in enumerate(zip(seen["logits"], seen0["logits"])):
        assert torch.equal(a, b), f"step {t}: LM-head logits differ"
    assert len(seen["routes"]) == len(seen0["routes"])
    for j, (a, b) in enumerate(zip(seen["routes"], seen0["routes"])):
        assert torch.equal(a, b), f"router call {j}: experts differ"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphs_match_the_plain_loop(monkeypatch, device, dtype):
    """A first call (one plain step, the capture, replays) and a second
    (replays only) against the plain loop, over left-padded rows: ids,
    each step's logits and each layer's routes identical."""
    dt = getattr(torch, dtype)
    cfg, lm = _lm(device, dt)
    inputs = _inputs(cfg, device, dt)
    want = _generate(monkeypatch, lm, cfg, inputs, plain=True)
    assert want[2] == {"lm.decode_steps": STEPS - 1,
                       "lm.decode_graph_steps": 0,
                       "lm.decode_graph_captures": 0}
    assert len(set(want[0][:, 1:].flatten().tolist())) > 1
    first = _generate(monkeypatch, lm, cfg, inputs)
    second = _generate(monkeypatch, lm, cfg, inputs, mode=torch.no_grad)
    for got in (first, second):
        _same(got, want)
    assert first[2] == {"lm.decode_steps": STEPS - 1,
                        "lm.decode_graph_steps": STEPS - 2,
                        "lm.decode_graph_captures": 1}
    assert second[2] == {"lm.decode_steps": STEPS - 1,
                         "lm.decode_graph_steps": STEPS - 1,
                         "lm.decode_graph_captures": 0}
    assert len(graphs.KEYS) == 1


def test_prompt_widths_alternate_on_two_keys(monkeypatch, device):
    """Prompt widths 7 and 9 in turn (caches of two widths): one capture
    a key, and every step after a key's first is a replay."""
    cfg, lm = _lm(device)
    total = dict.fromkeys(COUNTERS, 0)
    for W in (7, 9, 7, 9):
        inputs = _inputs(cfg, device, W=W, seed=W)
        want = _generate(monkeypatch, lm, cfg, inputs, plain=True)
        got = _generate(monkeypatch, lm, cfg, inputs)
        _same(got, want)
        for k in total:
            total[k] += got[2][k]
    assert total["lm.decode_graph_captures"] == 2 == len(graphs.KEYS)
    # the first step of each key's first call runs plain
    assert total["lm.decode_graph_steps"] == total["lm.decode_steps"] - 2


def test_new_weight_tensors_recapture(monkeypatch, device):
    """Replaced parameters (new storage) make a new key, captured anew;
    the old key's graphs are not replayed."""
    cfg, lm = _lm(device)
    inputs = _inputs(cfg, device)
    _generate(monkeypatch, lm, cfg, inputs)
    with torch.no_grad():
        layer = lm.layers[1]
        layer.ffn_norm = nn.Parameter(layer.ffn_norm * 1.5)
        layer.kvb = nn.Parameter(layer.kvb.flip(0))
    want = _generate(monkeypatch, lm, cfg, inputs, plain=True)
    got = _generate(monkeypatch, lm, cfg, inputs)
    _same(got, want)
    assert got[2]["lm.decode_graph_captures"] == 1
    assert len(graphs.KEYS) == 2


def test_wrappers_see_every_call_of_every_step(monkeypatch, device):
    """Wrappers replaced at call time see, at the prefill, each MoE
    layer's router and experts and the head; at every step, K11 once a
    layer with ``length`` a Python int (the column + 1), the router and
    the experts once a MoE layer and the head once. Each call's K11 reads
    the call's own ``key_ok``, the valid prompt columns then one a step."""
    cfg, lm = _lm(device)
    n, n_moe = cfg.num_hidden_layers, cfg.num_hidden_layers - 1
    inputs = _inputs(cfg, device)
    L = inputs[0].shape[1] + inputs[1].shape[1]
    key_oks = []
    for _ in range(2):  # the capture's call, then replays only
        _, seen, counts = _generate(monkeypatch, lm, cfg, inputs)
        steps = counts["lm.decode_steps"]
        assert steps == STEPS - 1
        assert len(seen["logits"]) == 1 + steps
        assert len(seen["routes"]) == seen["experts"] == n_moe * (1 + steps)
        assert len(seen["k11"]) == n * steps
        lengths = [length for _, length in seen["k11"]]
        assert all(type(length) is int for length in lengths)
        assert lengths == [L + 1 + t for t in range(steps) for _ in range(n)]
        oks = {id(k) for k, _ in seen["k11"]}
        assert len(oks) == 1
        key_ok = seen["k11"][0][0]
        want = torch.cat([torch.ones((4, inputs[0].shape[1])),
                          inputs[2].cpu().flip(1), torch.ones((4, steps))],
                         dim=1).to(torch.int8)
        assert torch.equal(key_ok.cpu(), want)
        key_oks.append(key_ok)
    assert key_oks[0] is not key_oks[1]


@pytest.mark.parametrize("case", ["cpu", "cuda"])
def test_the_plain_loop_runs_on_the_cpu(monkeypatch, case):
    """Only CUDA tensors take the graphs; a CPU decode counts no graph
    step and no capture and keeps no key."""
    dev = torch.device(case)
    assert graphs.use_graphs(dev, None) == (case == "cuda")
    if case == "cpu":
        cfg, lm = _lm(dev)
        ids, seen, counts = _generate(monkeypatch, lm, cfg,
                                      _inputs(cfg, dev))
        assert counts == {"lm.decode_steps": STEPS - 1,
                          "lm.decode_graph_steps": 0,
                          "lm.decode_graph_captures": 0}
        assert len(seen["logits"]) == STEPS and not graphs.KEYS


def test_benchmark_traced_run_over_emulated_graphs(tmp_path, monkeypatch):
    """The benchmark's LM cell at a tiny size, traced, with the CPU on the
    graph path: its wrappers on the head, the router, the experts and K11
    see every step (the check reads each step's logits and routes and
    finds them correct), and every step of the window is a replay (the
    warm-up pass captured)."""
    from portbench import run

    from tests.test_torch_moe_lm import CELL, TINY_LIMITS, tiny_registry

    _emulate(monkeypatch)
    # this suite's conftest loads jax; the run itself imports none of it
    monkeypatch.setattr(run, "banned_modules", lambda: [])
    out = run.run_cell(tiny_registry(tmp_path), CELL, 2 ** 31 + 13, 0.3,
                       True, torch.device("cpu"), t0=0.0)
    stdout, stderr = io.StringIO(), io.StringIO()
    assert run.emit(out, stdout, stderr) == 0
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS)
    assert res["metrics"]["lm.decode_graph_step_share"]["value"] == 100.0
    # requests of 12 rows in chunks of 8: a key at 8 rows and one at 4
    assert len(graphs.KEYS) == 2


@pytest.mark.cuda
def test_card_cell_widths(monkeypatch):
    """A 4-layer cut of the LM at the benchmark cell's published widths
    and shapes (bf16, B 512, a 50-token prefix and 64-token prompts, 20
    tokens: T 133): the graph path's first and second calls against the
    plain loop, ids, logits and routes bit-equal."""
    dev = _card()
    cfg = moe_lm.LMConfig(num_hidden_layers=4)
    with torch.device("meta"):
        lm = moe_lm.hold_in(moe_lm.MoELM(cfg), torch.bfloat16)
    lm = lm.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, cfg.init_std, generator=gen)
    inputs = _inputs(cfg, dev, torch.bfloat16, B=512, P=50, W=64)
    want = _generate(monkeypatch, lm, cfg, inputs, plain=True, steps=20)
    assert want[2]["lm.decode_steps"] == 19
    for _ in range(2):
        got = _generate(monkeypatch, lm, cfg, inputs, steps=20)
        _same(got, want)
        assert graphs.KEYS._sets and next(iter(
            graphs.KEYS._sets.values())).state.cache.shape[2] == 133
    assert got[2]["lm.decode_graph_steps"] == 19
