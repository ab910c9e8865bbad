"""The greedy decode's captured segments (``models/greedy.py``: CUDA graphs
of the kernel chains between a step's Python calls) against its plain
loop, for T5 and, in the cases over both generators, the LM.

Every scenario runs twice (``tests/torch_graph_emulation.py``).
``emulated`` (the CPU): a stand-in graph re-runs its segment into the
outputs it kept at capture, with the capture's writes to the decode state
undone, so the graph path's buffers, key cache, capture order and step
index run on CPU tensors. ``card`` (marked ``cuda``, skipped without one):
the real graphs on the card. Both are held to the plain loop on the same
device: greedy ids identical and each step's LM-head logits (and the LM's
routes) bit-equal, at a tiny t5-small shape, at t5-large's 16 heads and
width 1,024 and on a tiny LM, in fp32 and bf16; new weight tensors or TF32
flags (a recapture); and for T5 encoder widths that alternate on one key,
rows that reach EOS at different steps, int8 weights, weights updated in
place (read live) and a server pass under the benchmark's hooks on
``t5.dense`` and ``t5.decode_attention_for``, which see every LM head and
every attention call. On CPU tensors and under ``tp`` the plain loop runs
and the graph counters stay 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

from multimodalpromptretrieval_tpu_torch.models import greedy  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import graphs  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import quant  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402
from torch_graph_emulation import (  # noqa: E402,F401
    COUNTERS,
    LM,
    STEPS,
    T5,
    device,
    fresh,
    one_torch_thread,
    run,
    same,
)

GENERATORS = {"t5": T5(), "lm": LM()}
WIDTHS = {"t5_small": T5("t5_small"), "t5_large": T5("t5_large"), "lm": LM()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_graphs_match_the_plain_loop(monkeypatch, device, model, dtype):
    """A first call (one plain step, the capture, replays) and a second
    (replays only) against the plain loop: ids, each step's logits and the
    LM's routes identical."""
    gen, dt = WIDTHS[model], getattr(torch, dtype)
    cfg, params = gen.model(device, dt)
    inputs = gen.inputs(cfg, device, dt)
    want = run(gen, monkeypatch, cfg, params, inputs, plain=True)
    steps = STEPS - gen.prefill
    assert want[2] == {"decode_steps": steps, "decode_graph_steps": 0,
                       "decode_graph_captures": 0}
    assert len(set(want[0][:, 1:].flatten().tolist())) > 1
    first = run(gen, monkeypatch, cfg, params, inputs)
    second = run(gen, monkeypatch, cfg, params, inputs, mode=torch.no_grad)
    for got in (first, second):
        same(gen, got, want)
    assert first[2] == {"decode_steps": steps,
                        "decode_graph_steps": steps - 1,
                        "decode_graph_captures": 1}
    assert second[2] == {"decode_steps": steps, "decode_graph_steps": steps,
                         "decode_graph_captures": 0}
    assert len(graphs.KEYS) == 1


def test_encoder_widths_share_a_key(monkeypatch, device):
    """Encoder widths 7 and 11 in turn, then another batch size: one
    capture a (batch, weights) key, and every step after a key's first
    is a replay."""
    gen = GENERATORS["t5"]
    cfg, params = gen.model(device)
    calls = [gen.inputs(cfg, device, L=L, seed=L) for L in (7, 11, 7, 11)]
    calls.append(gen.inputs(cfg, device, B=3, seed=3))
    total = dict.fromkeys(COUNTERS, 0)
    for inputs in calls:
        want = run(gen, monkeypatch, cfg, params, inputs, plain=True)
        got = run(gen, monkeypatch, cfg, params, inputs)
        same(gen, got, want)
        for k in total:
            total[k] += got[2][k]
    assert total["decode_graph_captures"] == 2 == len(graphs.KEYS)
    # the first step of each key's first call runs plain
    assert total["decode_graph_steps"] == total["decode_steps"] - 2


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
    gen = GENERATORS["t5"]
    cfg, params = gen.model(device)
    inputs = gen.inputs(cfg, device, B=8)
    steps = 12
    free = run(gen, monkeypatch, cfg, params, inputs, plain=True,
               steps=steps)
    run(gen, monkeypatch, cfg, params, inputs, steps=steps)  # the capture
    _arrange_eos(params, cfg, free[0])
    want = run(gen, monkeypatch, cfg, params, inputs, plain=True,
               steps=steps, early_stop=True)
    ends = [int((r == cfg.eos_token_id).nonzero()[0]) if
            (r == cfg.eos_token_id).any() else steps
            for r in want[0].cpu()[:, 1:]]
    assert len(set(ends)) >= 2, ends
    got = run(gen, monkeypatch, cfg, params, inputs, steps=steps,
              early_stop=True)
    same(gen, got, want)
    assert got[2]["decode_graph_captures"] == 0
    assert got[2]["decode_graph_steps"] == want[2]["decode_steps"]


def test_int8_weights(monkeypatch, device):
    """The W8A8 serving copy (``ops/quant``): its int8 payloads and scales
    are read by the captured segments."""
    gen = GENERATORS["t5"]
    holder = nn.Module()
    cfg, holder.t5 = gen.model("cpu")
    params = quant.quantize_params(holder, t5=True).t5
    for m in params.decoder.modules():  # QWeights are not module tensors
        for name, w in list(vars(m).items()):
            if isinstance(w, quant.QWeight):
                setattr(m, name, quant.QWeight(w.q8.to(device),
                                               w.q_scale.to(device)))
    params = params.to(device, torch.bfloat16)
    assert quant.quantized_paths(params)
    inputs = gen.inputs(cfg, device, torch.bfloat16, B=24)
    want = run(gen, monkeypatch, cfg, params, inputs, plain=True)
    for _ in range(2):
        same(gen, run(gen, monkeypatch, cfg, params, inputs), want)


@pytest.mark.parametrize("change", ["weights", "tf32"])
@pytest.mark.parametrize("generator", sorted(GENERATORS))
def test_new_weight_tensors_recapture(monkeypatch, device, generator, change):
    """Replaced parameters (new storage), or another TF32 setting (which
    a captured GEMM keeps), make a new key, captured anew; the old key's
    graphs are not replayed."""
    gen = GENERATORS[generator]
    cfg, params = gen.model(device)
    inputs = gen.inputs(cfg, device)
    run(gen, monkeypatch, cfg, params, inputs)
    if change == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    else:
        with torch.no_grad():
            gen.renew(params)
    want = run(gen, monkeypatch, cfg, params, inputs, plain=True)
    got = run(gen, monkeypatch, cfg, params, inputs)
    same(gen, got, want)
    assert got[2]["decode_graph_captures"] == 1
    assert len(graphs.KEYS) == 2


@pytest.mark.parametrize("generator, case", [
    ("t5", "cpu"), ("t5", "cuda_tp"), ("t5", "cpu_tp"), ("t5", "cuda"),
    ("lm", "cpu"), ("lm", "cuda")])
def test_the_plain_loop_runs_on_the_cpu_and_under_tp(monkeypatch, generator,
                                                     case):
    """Only CUDA tensors without tensor parallelism take the graphs; a CPU
    decode counts no graph step and no capture and keeps no key."""
    tp = object() if case.endswith("_tp") else None
    dev = torch.device("cuda" if case.startswith("cuda") else "cpu")
    assert greedy.use_graphs(dev, tp) == (case == "cuda")
    if case == "cpu":
        gen = GENERATORS[generator]
        cfg, params = gen.model(dev)
        _, seen, counts = run(gen, monkeypatch, cfg, params,
                              gen.inputs(cfg, dev))
        assert counts == {"decode_steps": STEPS - gen.prefill,
                          "decode_graph_steps": 0,
                          "decode_graph_captures": 0}
        assert len(seen["logits"]) == STEPS and not graphs.KEYS


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
        m.setattr(greedy, "use_graphs", lambda dev, tp: False)
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
