"""The Kimi-Linear LM generator (``models/moe_lm.py`` with KDA and NoPE MLA
layers, ``ops/kda.py``, the held expert share of ``ops/moe.py``) at a small
size with Kimi-Linear-48B-A3B's structure (a dense KDA layer, then MoE
layers; KDA beside MLA without rotation; one rank's experts of four), on
seeded random weights, against the plain reference
``portbench/reference/kimi_linear.py``; the KDA chunked form against its
recurrence and against transformers' gated delta rule; the expert share
against the uncut layer; the config's published keys. The ``card`` tests
(marked ``cuda``) hold K12 and K13 against their plain versions, K10 with a
held share, and K11 at 32 heads, at the benchmark cell's shapes.
"""

from __future__ import annotations

import math
import os
from types import SimpleNamespace

import pytest
import torch

from multimodalpromptretrieval_tpu_torch.models import moe_lm
from multimodalpromptretrieval_tpu_torch.ops import kda, mla, moe
from portbench.reference import kimi_linear as ref_kl
from portbench.reference import models as ref
from portbench.reference import moe_lm as ref_lm

# the published keys' names, at a small size: a dense KDA layer, MoE
# layers of KDA and NoPE MLA, 4 experts held of 16 (rank 0 of 4)
TINY = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 4,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
        "v_head_dim": 16, "q_lora_rank": None, "first_k_dense_replace": 1,
        "linear_attn_config": {"kda_layers": [1, 2, 4],
                               "full_attn_layers": [3], "num_heads": 2,
                               "head_dim": 16, "short_conv_kernel_size": 4},
        "mla_use_nope": True, "num_experts": 4, "num_experts_per_token": 3,
        "num_shared_experts": 1, "moe_renormalize": True,
        "moe_router_activation_func": "sigmoid", "use_grouped_topk": True,
        "num_expert_group": 1, "topk_group": 1, "routed_scaling_factor": 2.446,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "ep_size": 4,
        "init_std": 0.1}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(seed: int = 0, **kw):
    keys = {**TINY, **kw}
    cfg = moe_lm.LMConfig.from_dict(keys)
    return keys, cfg, moe_lm.MoELM(cfg, torch.Generator().manual_seed(seed))


def named(lm) -> dict:
    return {"lm." + n: p.detach() for n, p in lm.named_parameters()}


def inputs(cfg, lengths, width, seed=1, prefix=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.zeros(len(lengths), width, dtype=torch.long)
    mask = torch.zeros_like(ids)
    for r, n in enumerate(lengths):
        ids[r, :n] = torch.randint(2, cfg.vocab_size, (n,), generator=g)
        mask[r, :n] = 1
    pre = torch.randn(len(lengths), prefix, cfg.hidden_size, generator=g)
    return pre, ids, mask


def served(monkeypatch, lm, cfg, pre, ids, mask, steps):
    """(ids, the head's logits at the prefill and each step (B, S, V))."""
    seen = []
    head = moe_lm.lm_head

    def keep(x, w):
        y = head(x, w)
        seen.append(y)
        return y

    monkeypatch.setattr(moe_lm, "lm_head", keep)
    out = moe_lm.lm_generate(lm, cfg, pre, ids, mask, max_new_tokens=steps)
    return out, torch.stack(seen, dim=1)


def decay_inputs(B, L, H, K, seed=0, uniform=False, device="cpu"):
    """q, k, v, g, beta as the published init makes them: g = -exp(A)
    softplus(x + dt_bias), A = log U(1, 16), dt log-uniform in [1e-3,
    1e-1]."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    q, k, v = (torch.randn(B, L, H, K, **kw) for _ in range(3))
    A = 1 + 15 * torch.rand(H, 1, **kw)
    dt = torch.exp(math.log(1e-3) + math.log(100.0) * torch.rand(
        H, 1 if uniform else K, **kw))
    bias = dt + torch.log(-torch.expm1(-dt))
    x = 0.3 * torch.randn(B, L, H, 1 if uniform else K, **kw)
    gate = -A * torch.nn.functional.softplus(x + bias)
    beta = torch.rand(B, L, H, **kw)
    return q, k, v, gate.expand(B, L, H, K).contiguous(), beta


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


def test_config_maps_the_published_keys():
    keys, cfg, _ = tiny()
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok,
            cfg.n_shared_experts, cfg.router_width) == (4, 3, 1, 16)
    assert cfg.kda_layers == (1, 2, 4) and cfg.mla_use_nope
    assert [cfg.kind(i) for i in range(4)] == ["kda", "kda", "mla", "kda"]
    assert [cfg.slot(i) for i in range(4)] == [0, 1, 0, 2]
    assert (cfg.n_kda, cfg.n_mla, cfg.kda_width) == (3, 1, 32)
    published = dict(TINY, num_hidden_layers=27, num_experts=256,
                     linear_attn_config={
                         "full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
                         "kda_layers": [i for i in range(1, 28)
                                        if i % 4 and i != 27],
                         "num_heads": 32, "head_dim": 128,
                         "short_conv_kernel_size": 4},
                     model_type="kimi_linear", head_dim=72)
    full = moe_lm.LMConfig.from_dict(published)
    assert (full.n_kda, full.n_mla, full.router_width) == (20, 7, 1024)
    assert hash(full) == hash(moe_lm.LMConfig.from_dict(published))


@pytest.mark.parametrize("change, match", [
    ({"num_expert_group": 8}, "grouped top-k"),
    ({"n_routed_experts": 8}, "disagree"),
    ({"linear_attn_config": dict(TINY["linear_attn_config"],
                                 full_attn_layers=[2, 3])}, "split"),
    ({"num_experts_per_token": 17}, "router scores"),
    ({"moe_router_activation_func": "softmax"}, "scoring_func"),
    ({"q_lora_rank": 64}, "q_lora_rank"),
])
def test_config_refuses(change, match):
    with pytest.raises(ValueError, match=match):
        moe_lm.LMConfig.from_dict({**TINY, **change})


# ---------------------------------------------------------------------------
# KDA
# ---------------------------------------------------------------------------


def test_chunked_prefill_matches_the_recurrence():
    """Three chunks and a ragged fourth, pads inside a row, a state to
    start from: the chunked form's outputs and final state are the
    recurrence's, step by step; the prefill is the chunked form from zeros
    over the convolved inputs and only writes its state."""
    B, L, H, K = 2, 3 * kda.CHUNK + 17, 2, 16
    q, k, v, g, beta = decay_inputs(B, L, H, K)
    valid = torch.ones(B, L, dtype=torch.bool)
    valid[1, :9] = False
    valid[0, 70] = False
    s0 = torch.randn(B, H, K, K, generator=torch.Generator().manual_seed(3))
    o_chunk, s_chunk = kda.kda_chunked(q, k, v, g, beta, valid, s0,
                                       K ** -0.5)
    s_step = s0.clone()
    for t in range(L):
        ok = valid[:, t]
        o = kda.kda_decode(q[:, t], k[:, t], v[:, t],
                           torch.where(ok[:, None, None], g[:, t], 0.0),
                           torch.where(ok[:, None], beta[:, t], 0.0),
                           s_step, K ** -0.5)
        torch.testing.assert_close(o[ok], o_chunk[:, t][ok], rtol=1e-4,
                                   atol=1e-5)
    torch.testing.assert_close(s_chunk, s_step, rtol=1e-4, atol=1e-5)
    taps = torch.rand(3 * H * K, 4,
                      generator=torch.Generator().manual_seed(4)) - 0.5
    fresh = torch.full_like(s0, float("nan"))
    o_fresh = kda.kda_prefill(q, k, v, g, beta, valid, fresh, K ** -0.5,
                              taps)
    conv = [kda.short_conv(t.flatten(2), w, valid).view(t.shape)
            for t, w in zip((q, k, v), taps.chunk(3))]
    o_zero, s_zero = kda.kda_chunked(*conv, g, beta, valid,
                                     torch.zeros_like(s0), K ** -0.5)
    torch.testing.assert_close(o_fresh, o_zero)
    torch.testing.assert_close(fresh, s_zero)


def test_channel_uniform_gate_matches_transformers_gated_delta_rule():
    """With one decay for every channel of a head, KDA is the gated delta
    rule of Qwen3-Next; transformers' plain torch versions of it (chunked
    and recurrent) are an independent check of both of ours."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    qwen = pytest.importorskip(
        "transformers.models.qwen3_next.modeling_qwen3_next")
    B, L, H, K = 2, 2 * kda.CHUNK + 9, 2, 16
    q, k, v, g, beta = decay_inputs(B, L, H, K, seed=5, uniform=True)
    s0 = 0.1 * torch.randn(B, H, K, K,
                           generator=torch.Generator().manual_seed(6))
    valid = torch.ones(B, L, dtype=torch.bool)
    ours, state = kda.kda_chunked(q, k, v, g, beta, valid, s0, K ** -0.5)
    for fn in (qwen.torch_chunk_gated_delta_rule,
               qwen.torch_recurrent_gated_delta_rule):
        theirs, s_theirs = fn(q, k, v, g[..., 0], beta, initial_state=s0,
                              output_final_state=True,
                              use_qk_l2norm_in_kernel=True)
        torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(state, s_theirs, rtol=1e-4, atol=1e-5)
    step_state = s0.clone()
    o = kda.kda_decode(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0],
                       step_state, K ** -0.5)
    theirs, s1 = qwen.torch_recurrent_gated_delta_rule(
        q[:, :1], k[:, :1], v[:, :1], g[:, :1, :, 0], beta[:, :1],
        initial_state=s0, output_final_state=True,
        use_qk_l2norm_in_kernel=True)
    torch.testing.assert_close(o, theirs[:, 0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(step_state, s1, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The expert share
# ---------------------------------------------------------------------------


@torch.no_grad()
def test_the_ranks_shares_sum_to_the_uncut_layer():
    """Each of the four ranks computes its held experts' part of the
    routed sum (``moe_experts_held`` over experts 4 rank .. 4 rank + 3);
    with the shared expert counted once they add up to the reference's
    uncut layer over all 16 experts; the model's layer is rank 0's."""
    keys, cfg, lm = tiny(seed=2)
    p = lm.layers[1]
    g = torch.Generator().manual_seed(4)
    E_all, w = cfg.router_width, cfg.moe_intermediate_size
    d = cfg.hidden_size
    gate_up = torch.randn(E_all, 2 * w, d, generator=g) * 0.1
    down = torch.randn(E_all, d, w, generator=g) * 0.1
    h = torch.randn(40, d, generator=g)
    idx, w8 = moe.route(h, p.router, p.router_bias, cfg.num_experts_per_tok,
                        cfg.routed_scaling_factor, cfg.norm_topk_prob)
    total = torch.zeros(40, d)
    for rank in range(cfg.ep_size):
        part = slice(rank * 4, rank * 4 + 4)
        total += moe.moe_experts_held(h, idx, w8, gate_up[part], down[part],
                                      rank * 4, cfg.router_width)
    layer = SimpleNamespace(router=p.router, router_bias=p.router_bias,
                            experts_gate_up=gate_up[:4],
                            experts_down=down[:4])
    torch.testing.assert_close(moe_lm._routed(layer, cfg, h),
                               moe.moe_experts_held(h, idx, w8, gate_up[:4],
                                                    down[:4], 0, 16))
    total += moe_lm._mlp(h, p.shared_gate_up, p.shared_down)
    stats = {"route_excess": 0, "route_flips": 0, "route_decisions": 0,
             "flip_margin": 0.0, "margins": []}
    full = {"router": p.router, "router_bias": p.router_bias,
            "experts_gate_up": gate_up, "experts_down": down,
            "shared_gate_up": p.shared_gate_up,
            "shared_down": p.shared_down}
    with torch.no_grad(), ref.exact_fp32():
        want = ref_lm._moe(full, {"num_experts_per_tok": 3,
                                  "norm_topk_prob": True,
                                  "routed_scaling_factor": 2.446},
                           h, None, 0.0, stats, None)
    torch.testing.assert_close(total, want, rtol=1e-4, atol=1e-5)
    # rank 0 alone computes only what its experts give
    rank0 = moe.moe_experts_reference(
        h, torch.tensor([[0, 5, 9]]).expand(40, 3), torch.ones(40, 3),
        gate_up[:4], down[:4])
    only = moe.moe_experts_reference(
        h, torch.tensor([[0]]).expand(40, 1), torch.ones(40, 1),
        gate_up[:4], down[:4])
    torch.testing.assert_close(rank0, only)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@torch.no_grad()
def test_the_lm_matches_the_reference(monkeypatch):
    """Rows of unequal pad counts behind the prefix: the served prefill's
    and steps' logits against the reference's full forward over [prefix ||
    prompt || served tokens], each row alone over its real tokens."""
    keys, cfg, lm = tiny()
    lengths, steps = [7, 3, 10], 4
    pre, ids, mask = inputs(cfg, lengths, width=12)
    out, logits = served(monkeypatch, lm, cfg, pre, ids, mask, steps)
    w = named(lm)
    rows = [torch.cat([pre[r], ref_kl.embed(w, [torch.cat(
        [ids[r, :n], out[r, 1:steps]])])[0]]) for r, n in enumerate(lengths)]
    with ref.exact_fp32():
        hidden, _ = ref_kl.forward_rows(w, keys, rows)
        for r, n in enumerate(lengths):
            at = hidden[r][3 + n - 1:3 + n - 1 + steps]
            want = ref_kl.logits(w, at)
            torch.testing.assert_close(logits[r], want, rtol=2e-4,
                                       atol=2e-4)


@torch.no_grad()
def test_prefill_then_steps_match_the_full_prefill(monkeypatch):
    """n tokens prefilled and m steps through the recurrent, convolution
    and latent state give the logits of a prefill over all n + m."""
    keys, cfg, lm = tiny(seed=3)
    pre, ids, mask = inputs(cfg, [5, 8], width=8, seed=2)
    steps = 4
    out, logits = served(monkeypatch, lm, cfg, pre, ids, mask, steps)
    monkeypatch.undo()
    for t in range(1, steps):
        longer = torch.zeros(2, 8 + t, dtype=torch.long)
        longer_mask = torch.zeros_like(longer)
        for r, n in enumerate([5, 8]):
            longer[r, :n + t] = torch.cat([ids[r, :n], out[r, 1:t + 1]])
            longer_mask[r, :n + t] = 1
        embeds, valid = moe_lm.left_pack(lm.embed, pre, longer, longer_mask,
                                         cfg.pad_token_id, pads_first=True)
        B, L, _ = embeds.shape
        state = moe_lm.DecodeState(cfg, B, L, embeds.dtype, embeds.device)
        key_ok = torch.zeros((B, L), dtype=torch.int8)
        want = moe_lm.lm_prefill(lm, cfg, embeds, valid, state, key_ok)
        torch.testing.assert_close(logits[:, t], want, rtol=1e-4, atol=1e-4)


@torch.no_grad()
def test_logits_do_not_depend_on_the_pad_count(monkeypatch):
    """The same rows padded to 9 and to 15 columns: the pads before the
    prefix are identity steps of the recurrence, zero convolution inputs
    and masked keys, so every logit is the same."""
    keys, cfg, lm = tiny(seed=4)
    pre, ids, mask = inputs(cfg, [6, 9], width=9, seed=3)
    wide, wide_mask = (torch.nn.functional.pad(t, (0, 6)) for t in (ids, mask))
    a, la = served(monkeypatch, lm, cfg, pre, ids, mask, 5)
    b, lb = served(monkeypatch, lm, cfg, pre, wide, wide_mask, 5)
    assert torch.equal(a, b)
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)


def test_left_pack_puts_the_pads_first():
    emb = torch.arange(10.0)[:, None].expand(10, 2)
    pre = torch.full((2, 2, 2), -1.0)
    ids = torch.tensor([[3, 4, 0], [5, 0, 0]])
    mask = (ids > 0).long()
    x, ok = moe_lm.left_pack(emb, pre, ids, mask, 0, pads_first=True)
    assert ok.tolist() == [[False, True, True, True, True],
                           [False, False, True, True, True]]
    assert x[:, :, 0].tolist() == [[0, -1, -1, 3, 4], [0, 0, -1, -1, 5]]


# ---------------------------------------------------------------------------
# The benchmark's Kimi-Linear driver on the CPU
# ---------------------------------------------------------------------------

CELL = "kimi-linear-48b-a3b.serve-pass"
TINY_CLIP = dict(embed_dim=64, image_resolution=32, vision_width=64,
                 vision_layers=2, patch_size=16, context_length=32,
                 vocab_size=514, text_width=64, vision_heads_override=2,
                 text_heads_override=2)
TINY_LIMITS = {"query_err": 1e-4, "search_excess": 0, "prefix_err": 1e-4,
               "logit_err": 1e-4, "token_excess": 0, "route_excess": 0,
               "route_flip_share": 0.0}


def tiny_registry(tmp_path):
    import json

    from portbench.registry import HERE, Registry

    for d in ("configs", "workloads"):
        (tmp_path / d).mkdir(exist_ok=True)
    name = "kimi-linear-48b-a3b_ep4_vit-b32"
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    tiny_keys = {k: v for k, v in TINY.items() if k != "init_std"}
    cfg.update({**tiny_keys, "vocab_size": 4096})
    cfg["clip"].update(TINY_CLIP)
    cfg["settings"].update(batch_size=8, compute_dtype="float32")
    (tmp_path / "configs" / (name + ".json")).write_text(json.dumps(cfg))
    with open(os.path.join(HERE, "workloads", CELL + ".json")) as f:
        wl = json.load(f)
    wl["traffic"].update(n_train=10, n_validate=2, n_test=8, image_size=32)
    wl["check"].update(decode_rows=6, limits=TINY_LIMITS)
    wl["driver_args"]["request_rows"] = 12
    (tmp_path / "workloads" / (CELL + ".json")).write_text(json.dumps(wl))
    return Registry(data=str(tmp_path))


@pytest.mark.parametrize("trace", [False, True])
def test_driver_cpu_run(tmp_path, trace, monkeypatch):
    """The cell's driver end to end on the CPU at a tiny size in fp32: the
    check against ``reference/kimi_linear.py`` holds it to rounding; the
    traced run reports the held share (rank 0 of 4: about a quarter)."""
    import io
    import json

    from portbench import run

    monkeypatch.setattr(run, "banned_modules", lambda: [])
    out = run.run_cell(tiny_registry(tmp_path), CELL, 2 ** 31 + 17, 0.3,
                       trace, torch.device("cpu"), t0=0.0)
    stdout, stderr = io.StringIO(), io.StringIO()
    assert run.emit(out, stdout, stderr) == 0
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS)
    if trace:
        share = res["metrics"]["moe.held_row_share"]["value"]
        assert 5.0 < share < 50.0
        assert "lm.decode_ms_per_step" in res["metrics"]
        assert not {"kda.decode_roofline",
                    "kda.prefill_roofline"} & set(res["metrics"])


def test_driver_fp8_control_fails(tmp_path):
    """The reference with fp8 products in the program's place reads as not
    correct."""
    from portbench import run

    out = run.run_cell(tiny_registry(tmp_path), CELL, 7, 0.2, False,
                       torch.device("cpu"), control=True, t0=0.0)
    out.pop("_ctx")
    assert out["correct"] is False


# ---------------------------------------------------------------------------
# The card, at the cell's shapes
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float(((got.float() - want.float()).norm(dim=-1)
                  / want.float().norm(dim=-1).clamp(min=1e-30)).max())


# K13 in fp32 throughout, summed in another order than the plain version;
# its bf16 output rounds once (2^-9 relative)
_K13_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_kda_decode_kernel(dtype):
    """K13 at the cell's decode step (B 512, 32 heads of 128), the state
    of 20 prefilled tokens, without a host sync."""
    dev = _card()
    B, H, K = 512, 32, 128
    q, k, v, g, beta = decay_inputs(B, 1, H, K, seed=7, device=dev)
    q, k, v = (t[:, 0].to(dtype) for t in (q, k, v))
    g, beta = g[:, 0], beta[:, 0]
    state = 0.3 * torch.randn(B, H, K, K, device=dev,
                              generator=torch.Generator(dev).manual_seed(8))
    want_state = state.clone()
    want = kda.kda_decode_reference(q, k, v, g, beta, want_state, K ** -0.5)
    out = torch.empty_like(v)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kda.kda_decode(q, k, v, g, beta, state, K ** -0.5, out=out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got is out
    assert _rel(got, want) < _K13_TOL[dtype]
    assert _rel(state.flatten(2), want_state.flatten(2)) < 1e-5


# K12 runs its four state products with TF32 operands (2^-11 relative)
# and the rest in fp32; the bf16 output rounds once more (2^-9)
_K12_TOL = {torch.float32: 4e-3, torch.bfloat16: 8e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [4, 2])
def test_card_kda_prefill_kernel(dtype, width):
    """K12 at the cell's prefill (114 columns: a chunk of 64 and one of
    50, 32 heads of 128) over 8 rows with 0-24 pads first, and the decay
    as the published init makes it; q / k / v read through the strides of
    the model's [q | k | v] rows and through the fused short convolution
    (the cell's 4 taps, and 2); the state it was given is not read; no
    host sync."""
    dev = _card()
    B, L, H, K = 8, 114, 32, 128
    q, k, v, g, beta = decay_inputs(B, L, H, K, seed=9, device=dev)
    qkv = torch.stack([q, k, v], dim=2).to(dtype)  # (B, L, 3, H, K)
    q, k, v = qkv.unbind(2)
    taps = (torch.rand(3 * H * K, width, device=dev,
                       generator=torch.Generator(dev).manual_seed(12))
            - 0.5).to(dtype)
    valid = torch.ones(B, L, dtype=torch.bool, device=dev)
    for r in range(B):
        valid[r, :3 * r] = False
    state = torch.full((B, H, K, K), float("nan"), device=dev)
    want_state = torch.empty_like(state)
    want = kda.kda_prefill_reference(q, k, v, g, beta, valid, want_state,
                                     K ** -0.5, taps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kda.kda_prefill(q, k, v, g, beta, valid, state, K ** -0.5,
                              taps)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _rel(got[valid], want[valid]) < _K12_TOL[dtype]
    assert _rel(state.flatten(2), want_state.flatten(2)) < _K12_TOL[
        torch.float32]


@pytest.mark.cuda
def test_card_kda_prefill_at_the_cell_batch():
    """K12 over the cell's whole chunk (512 rows x 114 columns), then K13
    for a step from its state: rows 0-3 as the plain versions compute them
    alone."""
    dev = _card()
    B, L, H, K = 512, 114, 32, 128
    q, k, v, g, beta = decay_inputs(B, L + 1, H, K, seed=11,
                                   device=dev)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    valid = torch.ones(B, L, dtype=torch.bool, device=dev)
    valid[:, :7] = False
    taps = (torch.rand(3 * H * K, 4, device=dev,
                       generator=torch.Generator(dev).manual_seed(13))
            - 0.5).bfloat16()
    state = torch.empty(B, H, K, K, device=dev)
    got = kda.kda_prefill(q[:, :L], k[:, :L], v[:, :L], g[:, :L],
                          beta[:, :L], valid, state, K ** -0.5, taps)
    step = kda.kda_decode(q[:, L], k[:, L], v[:, L], g[:, L], beta[:, L],
                          state, K ** -0.5)
    few = torch.empty(4, H, K, K, device=dev)
    want = kda.kda_prefill_reference(q[:4, :L], k[:4, :L], v[:4, :L],
                                     g[:4, :L], beta[:4, :L], valid[:4], few,
                                     K ** -0.5, taps)
    want_step = kda.kda_decode_reference(q[:4, L], k[:4, L], v[:4, L],
                                         g[:4, L], beta[:4, L], few,
                                         K ** -0.5)
    assert _rel(got[:4][valid[:4]], want[valid[:4]]) < _K12_TOL[
        torch.bfloat16]
    assert _rel(step[:4], want_step) < _K12_TOL[torch.bfloat16]
    assert bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(state).all())


# fp32 sums of bf16 products, as test_torch_moe_lm's _MOE_TOL
_MOE_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [512, 8192])
def test_card_moe_experts_held_share(tokens):
    """K10 holding rank 0's 64 of 256 experts at Kimi-Linear's widths: a
    decode step (512 tokens x 8, ~16 rows a held expert, tiles of 64) and
    a prefill's worth (8,192 x 8, ~256 rows a held expert, the wgmma
    tiles); the rows routed elsewhere add nothing; no host sync."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(tokens)
    d, I, E, routed, k = 2304, 1024, 64, 256, 8
    h = torch.randn(tokens, d, generator=g, device=dev).bfloat16()
    gate_up = (torch.randn(E, 2 * I, d, generator=g, device=dev)
               * 0.02).bfloat16()
    down = (torch.randn(E, d, I, generator=g, device=dev) * 0.02).bfloat16()
    idx = torch.topk(torch.rand(tokens, routed, generator=g, device=dev),
                     k, dim=-1).indices
    w = torch.rand(tokens, k, generator=g, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_experts_held(h, idx, w, gate_up, down, 0, routed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = moe.moe_experts_reference(h.float(), idx, w, gate_up.float(),
                                     down.float())
    none = ~(idx < E).any(dim=1)
    assert bool((got[none] == 0).all())
    assert _rel(got[~none], want[~none]) < _MOE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [512, 58368])
def test_card_moe_experts_all_held_is_bit_identical(tokens):
    """At Kimi-VL-A3B's shapes (64 experts, 6 a token: a decode step and a
    whole prefill chunk) a share that holds every expert gives the same
    bits as the call without a share."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(tokens)
    d, I, E, k = 2048, 1408, 64, 6
    h = torch.randn(tokens, d, generator=g, device=dev).bfloat16()
    gate_up = (torch.randn(E, 2 * I, d, generator=g, device=dev)
               * 0.02).bfloat16()
    down = (torch.randn(E, d, I, generator=g, device=dev) * 0.02).bfloat16()
    idx = torch.topk(torch.rand(tokens, E, generator=g, device=dev), k,
                     dim=-1).indices
    w = torch.rand(tokens, k, generator=g, device=dev)
    plain = moe.moe_experts(h, idx, w, gate_up, down)
    held = moe.moe_experts_held(h, idx, w, gate_up, down, 0, E)
    assert torch.equal(plain, held)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 114, 133])
def test_card_mla_decode_kernel_at_32_heads(length):
    """K11 at Kimi-Linear's 32 heads (two blocks a row, each 16 heads),
    the cell's latent cache of 133 columns."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(length)
    B, T, H, C, R = 512, 133, 32, 512, 64
    q = torch.randn(B, H, C, generator=g, device=dev).bfloat16()
    qp = torch.randn(B, H, R, generator=g, device=dev).bfloat16()
    cache = torch.randn(B, T, C + R, generator=g, device=dev).bfloat16()
    ok = (torch.rand(B, T, generator=g, device=dev) > 0.2).to(torch.int8)
    ok[:, 0] = 1
    got = mla.mla_decode_attention(q, qp, cache, ok, length, 192 ** -0.5)
    want = mla.mla_decode_attention_reference(q.float(), qp.float(),
                                              cache.float(), ok, length,
                                              192 ** -0.5)
    assert _rel(got, want) < 1.5e-2
