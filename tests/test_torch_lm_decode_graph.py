"""The LM's greedy decode as captured segments (``models/moe_lm.py``: CUDA
graphs of the kernel chains between a step's K11, router, expert and head
calls) against its plain loop, in the scenarios only the LM has; those it
shares with T5 are cases of ``tests/test_torch_decode_graph.py``.

Each scenario runs on emulated graphs on the CPU and, marked ``cuda``, on
the card (``tests/torch_graph_emulation.py``): two prompt widths
alternating (two keys); stand-in wrappers on ``moe.route``,
``moe.moe_experts``, ``mla.mla_decode_attention`` and ``moe_lm.lm_head``
that see every call of every step; the benchmark's traced LM cell at a
tiny size; and, on the card only, a 4-layer cut of the LM at the benchmark
cell's widths and shapes (B 512, T 133).
"""

import io
import json

import pytest

torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu_torch.models import moe_lm  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import graphs  # noqa: E402
from torch_graph_emulation import (  # noqa: E402,F401
    COUNTERS,
    LM,
    STEPS,
    card,
    device,
    emulate,
    fresh,
    one_torch_thread,
    run,
    same,
)

GEN = LM()


def test_prompt_widths_alternate_on_two_keys(monkeypatch, device):
    """Prompt widths 7 and 9 in turn (caches of two widths): one capture
    a key, and every step after a key's first is a replay."""
    cfg, lm = GEN.model(device)
    total = dict.fromkeys(COUNTERS, 0)
    for W in (7, 9, 7, 9):
        inputs = GEN.inputs(cfg, device, W=W, seed=W)
        want = run(GEN, monkeypatch, cfg, lm, inputs, plain=True)
        got = run(GEN, monkeypatch, cfg, lm, inputs)
        same(GEN, got, want)
        for k in total:
            total[k] += got[2][k]
    assert total["decode_graph_captures"] == 2 == len(graphs.KEYS)
    # the first step of each key's first call runs plain
    assert total["decode_graph_steps"] == total["decode_steps"] - 2


def test_wrappers_see_every_call_of_every_step(monkeypatch, device):
    """Wrappers replaced at call time see, at the prefill, each MoE
    layer's router and experts and the head; at every step, K11 once a
    layer with ``length`` a Python int (the column + 1), the router and
    the experts once a MoE layer and the head once. Each call's K11 reads
    the call's own ``key_ok``, the valid prompt columns then one a step."""
    cfg, lm = GEN.model(device)
    n, n_moe = cfg.num_hidden_layers, cfg.num_hidden_layers - 1
    inputs = GEN.inputs(cfg, device)
    L = inputs[0].shape[1] + inputs[1].shape[1]
    key_oks = []
    for _ in range(2):  # the capture's call, then replays only
        _, seen, counts = run(GEN, monkeypatch, cfg, lm, inputs)
        steps = counts["decode_steps"]
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


def test_benchmark_traced_run_over_emulated_graphs(tmp_path, monkeypatch):
    """The benchmark's LM cell at a tiny size, traced, with the CPU on the
    graph path: its wrappers on the head, the router, the experts and K11
    see every step (the check reads each step's logits and routes and
    finds them correct), and every step of the window is a replay (the
    warm-up pass captured)."""
    from portbench import run

    from tests.test_torch_moe_lm import CELL, TINY_LIMITS, tiny_registry

    emulate(monkeypatch)
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
    dev = card()
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
    inputs = GEN.inputs(cfg, dev, torch.bfloat16, B=512, P=50, W=64)
    want = run(GEN, monkeypatch, cfg, lm, inputs, plain=True, steps=20)
    assert want[2]["decode_steps"] == 19
    for _ in range(2):
        got = run(GEN, monkeypatch, cfg, lm, inputs, steps=20)
        same(GEN, got, want)
        assert graphs.KEYS._sets and next(iter(
            graphs.KEYS._sets.values())).state.cache.shape[2] == 133
    assert got[2]["decode_graph_steps"] == 19
