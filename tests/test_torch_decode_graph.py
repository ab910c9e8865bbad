"""The greedy decode's captured segments (``models/t5.py``: CUDA graphs of
the kernel chains between a step's attention calls) against its plain loop.

Every scenario runs twice. ``emulated`` (the CPU): a stand-in graph
re-runs its segment into the outputs it kept at capture, with the capture's
side effects undone, so the graph path's buffers, key cache, capture order
and step index run on CPU tensors. ``card`` (marked ``cuda``, skipped
without one): the real graphs on the card. Both are held to the plain
loop on the same device: greedy ids identical and each step's LM-head
logits bit-equal, at a tiny t5-small shape and at t5-large's 16 heads and
width 1,024, in fp32 and bf16; encoder widths that alternate on one key;
rows that reach EOS at different steps; int8 weights; new weight tensors
(a recapture) and weights updated in place (read live); and a server pass
under the benchmark's hooks on ``t5.dense`` and ``t5.decode_attention_for``,
which see every LM head and every attention call. On CPU tensors and under
``tp`` the plain loop runs and the graph counters stay 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

from multimodalpromptretrieval_tpu_torch.models import t5 as pt5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import graphs  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import quant  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402

# d_model, heads, d_ff, decoder layers; d_kv 64, the kernels' head dim
SHAPES = {"t5_small": (512, 8, 2048, 2), "t5_large": (1024, 16, 4096, 2)}
VOCAB = 1000  # apart from W and 3W: the hooks below tell the LM head by it
STEPS = 6


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
    state it wrote put back (a capture launches nothing), then re-run at
    each replay into those same outputs (a replay rewrites them in
    place)."""

    def __init__(self, pool, stream):
        pass

    def capture(self, fn, *args):
        kept = [(t, t.clone()) for a in args
                if isinstance(a, pt5._DecodeState) for t in (a.kv, a.step)]
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
                held.copy_(value)
        return self.out


@pytest.fixture(params=["emulated",
                        pytest.param("card", marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    """The device of the graph path: the CPU with emulated graphs, or the
    card."""
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda")
    monkeypatch.setattr(graphs, "Graph", _EmulatedGraph)
    monkeypatch.setattr(graphs, "use_graphs", lambda dev, tp: tp is None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    return torch.device("cpu")


def _cfg(shape: str = "t5_small") -> pt5.T5Config:
    d, h, ff, layers = SHAPES[shape]
    return pt5.T5Config(vocab_size=VOCAB, d_model=d, d_kv=64, d_ff=ff,
                        num_layers=1, num_decoder_layers=layers, num_heads=h)


def _params(cfg, device, dtype=torch.float32, seed=0):
    """Seeded weights; the pad (start) embedding zeroed, since a random T5
    otherwise re-emits its input token at every step."""
    params = pt5.T5(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        params.shared[cfg.pad_token_id] = 0.0
    return params.to(device, dtype)


def _inputs(cfg, device, dtype=torch.float32, B=4, L=7, seed=1):
    g = torch.Generator().manual_seed(seed)
    hidden = torch.randn((B, L, cfg.d_model), generator=g)
    mask = torch.ones((B, L), dtype=torch.int32)
    mask[0, L // 2:] = 0
    return hidden.to(device, dtype), mask.to(device)


def _decode(monkeypatch, params, cfg, hidden, mask, *, plain=False,
            steps=STEPS, early_stop=False, mode=torch.inference_mode):
    """(ids, each step's LM-head logits, counters of this call); ``plain``:
    the plain loop on the same device."""
    logits = []
    dense = pt5.dense

    def lm_dense(x, weight, bias=None):
        y = dense(x, weight, bias)
        if x.dim() == 2 and y.shape[-1] == cfg.vocab_size:
            logits.append(y.clone())
        return y

    with monkeypatch.context() as m:
        m.setattr(pt5, "dense", lm_dense)
        if plain:
            m.setattr(graphs, "use_graphs", lambda dev, tp: False)
        before = dict(profiling.snapshot()["counters"])
        with mode():
            ids = pt5.t5_greedy_decode(params, cfg, hidden, mask,
                                       max_new_tokens=steps,
                                       early_stop=early_stop)
        after = profiling.snapshot()["counters"]
    counts = {k: after.get(k, 0) - before.get(k, 0)
              for k in ("t5.decode_steps", "t5.decode_graph_steps",
                        "t5.decode_graph_captures")}
    return ids, logits, counts


def _same(got, want):
    ids, logits, counts = got
    ids0, logits0, counts0 = want
    assert torch.equal(ids.cpu(), ids0.cpu())
    assert len(logits) == len(logits0) == counts0["t5.decode_steps"]
    for t, (a, b) in enumerate(zip(logits, logits0)):
        assert torch.equal(a, b), f"step {t}: LM-head logits differ"
    assert counts["t5.decode_steps"] == counts0["t5.decode_steps"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_graphs_match_the_plain_loop(monkeypatch, device, shape, dtype):
    """A first call (one plain step, the capture, replays) and a second
    (replays only) against the plain loop: ids and each step's logits
    identical."""
    dt = getattr(torch, dtype)
    cfg = _cfg(shape)
    params = _params(cfg, device, dt)
    hidden, mask = _inputs(cfg, device, dt)
    want = _decode(monkeypatch, params, cfg, hidden, mask, plain=True)
    assert want[2]["t5.decode_graph_steps"] == 0
    assert len(set(want[0][:, 1:].flatten().tolist())) > 1
    first = _decode(monkeypatch, params, cfg, hidden, mask)
    second = _decode(monkeypatch, params, cfg, hidden, mask,
                     mode=torch.no_grad)
    for got in (first, second):
        _same(got, want)
    assert first[2] == {"t5.decode_steps": STEPS,
                        "t5.decode_graph_steps": STEPS - 1,
                        "t5.decode_graph_captures": 1}
    assert second[2] == {"t5.decode_steps": STEPS,
                         "t5.decode_graph_steps": STEPS,
                         "t5.decode_graph_captures": 0}


def test_encoder_widths_share_a_key(monkeypatch, device):
    """Encoder widths 7 and 11 in turn, then another batch size: one
    capture a (batch, weights) key, and every step after a key's first
    is a replay."""
    cfg = _cfg()
    params = _params(cfg, device)
    calls = [_inputs(cfg, device, L=L, seed=L) for L in (7, 11, 7, 11)]
    calls.append(_inputs(cfg, device, B=3, seed=3))
    total = {"t5.decode_steps": 0, "t5.decode_graph_steps": 0,
             "t5.decode_graph_captures": 0}
    for hidden, mask in calls:
        want = _decode(monkeypatch, params, cfg, hidden, mask, plain=True)
        got = _decode(monkeypatch, params, cfg, hidden, mask)
        _same(got, want)
        for k in total:
            total[k] += got[2][k]
    assert total["t5.decode_graph_captures"] == 2 == len(graphs.KEYS)
    # the first step of each key's first call runs plain
    assert total["t5.decode_graph_steps"] == total["t5.decode_steps"] - 2


def _arrange_eos(params, cfg, ids):
    """Rows that stop at different steps: the EOS row of the tied
    embedding becomes twice the row of the token (of the ids the plain
    loop emits without EOS) that rows first emit at the most distinct
    steps, so that EOS outscores it where it leads."""
    ids = ids.cpu()[:, 1:]
    special = {cfg.pad_token_id, cfg.eos_token_id,
               cfg.decoder_start_token_id}
    best, firsts = None, 0
    for v in sorted(set(ids.flatten().tolist()) - special):
        hit = ids == v
        n = len({int(r.nonzero()[0]) for r in hit if r.any()})
        if n > firsts:
            best, firsts = v, n
    assert best is not None
    with torch.no_grad():
        params.shared[cfg.eos_token_id] = 2 * params.shared[best]


def test_early_stop_rows_finish_at_different_steps(monkeypatch, device):
    """EOS arranged through the LM-head weights (updated in place, so the
    captured key reads them live): the same ids and the same number of
    steps as the plain loop, with rows done at two or more steps."""
    cfg = _cfg()
    params = _params(cfg, device)
    hidden, mask = _inputs(cfg, device, B=8)
    steps = 12
    free = _decode(monkeypatch, params, cfg, hidden, mask, plain=True,
                   steps=steps)
    _decode(monkeypatch, params, cfg, hidden, mask, steps=steps)  # capture
    _arrange_eos(params, cfg, free[0])
    want = _decode(monkeypatch, params, cfg, hidden, mask, plain=True,
                   steps=steps, early_stop=True)
    ends = [int((r == cfg.eos_token_id).nonzero()[0]) if
            (r == cfg.eos_token_id).any() else steps
            for r in want[0].cpu()[:, 1:]]
    assert len(set(ends)) >= 2, ends
    got = _decode(monkeypatch, params, cfg, hidden, mask, steps=steps,
                  early_stop=True)
    _same(got, want)
    assert got[2]["t5.decode_graph_captures"] == 0
    assert got[2]["t5.decode_graph_steps"] == want[2]["t5.decode_steps"]


def test_int8_weights(monkeypatch, device):
    """The W8A8 serving copy (``ops/quant``): its int8 payloads and scales
    are read by the captured segments."""
    cfg = _cfg()
    holder = nn.Module()
    holder.t5 = _params(cfg, "cpu")
    params = quant.quantize_params(holder, t5=True).t5
    for m in params.decoder.modules():  # QWeights are not module tensors
        for name, w in list(vars(m).items()):
            if isinstance(w, quant.QWeight):
                setattr(m, name, quant.QWeight(w.q8.to(device),
                                               w.q_scale.to(device)))
    params = params.to(device, torch.bfloat16)
    assert quant.quantized_paths(params)
    hidden, mask = _inputs(cfg, device, torch.bfloat16, B=24)
    want = _decode(monkeypatch, params, cfg, hidden, mask, plain=True)
    for _ in range(2):
        _same(_decode(monkeypatch, params, cfg, hidden, mask), want)


@pytest.mark.parametrize("change", ["weights", "tf32"])
def test_new_weight_tensors_recapture(monkeypatch, device, change):
    """A replaced parameter (new storage), or another TF32 setting (which
    a captured GEMM keeps), makes a new key, captured anew; the old key's
    graphs are not replayed."""
    cfg = _cfg()
    params = _params(cfg, device)
    hidden, mask = _inputs(cfg, device)
    _decode(monkeypatch, params, cfg, hidden, mask)
    if change == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    else:
        block = params.decoder.block[1]
        with torch.no_grad():
            block.ff_ln = nn.Parameter(block.ff_ln * 1.5)
            block.self_attn.o.weight = nn.Parameter(
                block.self_attn.o.weight.flip(0))
    want = _decode(monkeypatch, params, cfg, hidden, mask, plain=True)
    got = _decode(monkeypatch, params, cfg, hidden, mask)
    _same(got, want)
    assert got[2]["t5.decode_graph_captures"] == 1
    assert len(graphs.KEYS) == 2


@pytest.mark.parametrize("case", ["cpu", "cuda_tp", "cpu_tp", "cuda"])
def test_the_plain_loop_runs_on_the_cpu_and_under_tp(monkeypatch, case):
    """Only CUDA tensors without tensor parallelism take the graphs; a CPU
    decode counts no graph step and no capture."""
    tp = object() if case.endswith("_tp") else None
    dev = torch.device("cuda" if case.startswith("cuda") else "cpu")
    assert graphs.use_graphs(dev, tp) == (case == "cuda")
    if case == "cpu":
        cfg = _cfg()
        params = _params(cfg, dev)
        hidden, mask = _inputs(cfg, dev)
        _, logits, counts = _decode(monkeypatch, params, cfg, hidden, mask)
        assert counts == {"t5.decode_steps": STEPS,
                          "t5.decode_graph_steps": 0,
                          "t5.decode_graph_captures": 0}
        assert len(logits) == STEPS and not graphs.KEYS


def test_server_hooks_see_every_lm_head_and_attention_call(monkeypatch,
                                                           device,
                                                           tmp_path):
    """A fused-path server under the benchmark's hooks (``portbench/
    instrument.py``): ``Capture`` on ``t5.dense`` keeps each greedy step's
    logits, one a step run; ``Spans.kernel_spans`` on
    ``t5.decode_attention_for`` sees 2L attention calls a step; after the
    warm-up pass every step is a replay; answers equal the plain loop's."""
    from portbench import instrument

    from multimodalpromptretrieval_tpu_torch.serve import MPRServer
    from multimodalpromptretrieval_tpu_torch.serving import (
        ServingExperiment,
        synthetic_config,
        synthetic_slake,
    )

    splits, images = synthetic_slake(16, 8, image_size=32, seed=0,
                                     n_validate=2)
    cfg = synthetic_config(batch_size=4, epochs=1, retrieval=True, k=1,
                           image_size=32)
    cfg["t5_overrides"].update(d_model=128, d_kv=64, num_heads=2, d_ff=256)
    exp = ServingExperiment(cfg, train=splits["train"],
                            validate=splits["validate"],
                            test=splits["test"], images=images,
                            device=device, model_root=str(tmp_path))
    t5cfg = exp.model_cfg.t5
    L = t5cfg.num_decoder_layers
    tests = exp.splits["test"][:8]

    names = list(dict.fromkeys(e["image_name"] for e in tests))

    def serve(server):
        server.stage_images(np.stack([images[n] for n in names]), names)
        return server.submit(None, [e["question"] for e in tests],
                             [e["task"] for e in tests],
                             image_ids=[e["image_name"]
                                        for e in tests]).result()

    with monkeypatch.context() as m:
        m.setattr(graphs, "use_graphs", lambda dev, tp: False)
        want = serve(MPRServer(exp, load_checkpoint=False))
    server = MPRServer(exp, load_checkpoint=False)
    serve(server)  # the warm-up pass: one plain step, then the capture
    profiling.reset()
    capture = instrument.Capture(keep=2, select={0: [0, 1], 1: [3]},
                                 vocab=t5cfg.vocab_size)
    spans = instrument.Spans(exp)
    spans.kernel_spans()
    steps0 = server.decode_steps
    try:
        got = serve(server)
    finally:
        spans.restore()
        capture.restore()
    steps = server.decode_steps - steps0
    counters = profiling.snapshot()["counters"]
    assert got == want
    assert len(capture.records) == 2
    assert sum(len(r["logits"]) for r in capture.records) == steps > 0
    assert all(r["logits"][0].shape[-1] == t5cfg.vocab_size
               for r in capture.records)
    decode_calls = [c for c in spans.kernel_calls
                    if c["kernel"] == "decode_attention"]
    assert len(decode_calls) == 2 * L * steps
    assert counters["t5.decode_steps"] == steps
    assert counters["t5.decode_graph_steps"] == steps
    assert counters.get("t5.decode_graph_captures", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["self", "cross"])
@pytest.mark.parametrize("kernel", ["decode_attention",
                                    "decode_attention_fused"])
def test_cuda_decode_attention_into_out(kernel, case, dtype):
    """K6 / K7 with ``out=`` (the fixed attention output the captured
    segments read) at t5-large's 16 heads: one launch, the given tensor
    returned, bit-equal to a new result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from multimodalpromptretrieval_tpu_torch.ops import _build, decode_attention

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    B, H, T = 128, 16, 20 if case == "self" else 114
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g).to(dev, dt)
               for shape in ((B, H * 64), (B, T, H * 64), (B, T, H * 64)))
    bias = mask = None
    if case == "self":
        bias = torch.randn((H, T), generator=g).to(dev)
    else:
        mask = (torch.rand((B, T), generator=g) > 0.3).int().to(dev)
        mask[:, 0] = 1
    fn = getattr(decode_attention, kernel)
    want = fn(q, k, v, bias, mask, heads=H)
    out = torch.full_like(want, float("nan"))
    before = _build.launch_counts()[kernel]
    assert fn(q, k, v, bias, mask, heads=H, out=out) is out
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert torch.equal(out, want)
