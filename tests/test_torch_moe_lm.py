"""The LM generator (``models/moe_lm.py``, ``ops/moe.py``, ``ops/mla.py``)
at a small size with Kimi-VL-A3B's structure (a dense layer, then MoE
layers with shared experts; latent attention with a decoupled rope part),
on seeded random weights, against the plain reference
``portbench/reference/moe_lm.py``; the server with the LM generator, its
refusals, and the benchmark's LM driver on the CPU. The ``card`` tests
(marked ``cuda``) hold the latent decode kernel (K11) and the grouped
expert GEMMs (K10) against their plain versions at the benchmark cell's
shapes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from multimodalpromptretrieval_tpu_torch import serve, serving
from multimodalpromptretrieval_tpu_torch.models import moe_lm
from multimodalpromptretrieval_tpu_torch.ops import mla, moe
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh
from portbench.reference import models as ref
from portbench.reference import moe_lm as ref_lm

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=4, n_shared_experts=2,
            n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_lm(seed: int = 0, **kw):
    cfg = moe_lm.LMConfig(**{**TINY, **kw})
    # a std above DeepSeek's 0.02 so the tiny model's logits and routes
    # spread as the full model's do
    cfg = dataclasses.replace(cfg, init_std=0.1)
    return cfg, moe_lm.MoELM(cfg, torch.Generator().manual_seed(seed))


def named(lm: moe_lm.MoELM) -> dict:
    return {"lm." + n: p.detach() for n, p in lm.named_parameters()}


def test_config_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="q_lora_rank"):
        moe_lm.LMConfig(q_lora_rank=1536)
    with pytest.raises(ValueError, match="n_group"):
        moe_lm.LMConfig(n_group=8)
    cfg = moe_lm.LMConfig.from_dict({"hidden_size": 64, "model_type": "x"})
    assert cfg.hidden_size == 64 and cfg.cache_width == 576


@pytest.mark.parametrize("masked", [False, True])
def test_absorbed_latent_decode_equals_non_absorbed(masked):
    """``q_lat = q_nope W_UK`` over the latent cache, then ``W_UV``, is the
    per-head attention over k_nope = W_UK c, v = W_UV c (fp32, the products
    summed in two orders)."""
    g = torch.Generator().manual_seed(1)
    B, T, H, C, R, dn, dv = 3, 9, 4, 32, 16, 16, 16
    c = torch.randn(B, T, C, generator=g, dtype=torch.float32)
    k_pe = torch.randn(B, T, R, generator=g, dtype=torch.float32)
    q_nope = torch.randn(B, H, dn, generator=g, dtype=torch.float32)
    q_pe = torch.randn(B, H, R, generator=g, dtype=torch.float32)
    w = torch.randn(H, dn + dv, C, generator=g, dtype=torch.float32) * 0.2
    w_uk, w_uv = w[:, :dn], w[:, dn:]
    ok = torch.ones(B, T, dtype=torch.int8)
    if masked:
        ok[0, :4] = 0
        ok[2, 5] = 0
    scale = (dn + R) ** -0.5
    k_nope = torch.einsum("btc,hnc->bhtn", c, w_uk)
    v = torch.einsum("btc,hvc->bhtv", c, w_uv)
    s = (torch.einsum("bhn,bhtn->bht", q_nope, k_nope)
         + torch.einsum("bhr,btr->bht", q_pe, k_pe)) * scale
    s = s.masked_fill(~ok[:, None].bool(), float("-inf"))
    plain = torch.einsum("bht,bhtv->bhv", torch.softmax(s, -1), v)
    q_lat = torch.einsum("bhn,hnc->bhc", q_nope, w_uk)
    cache = torch.cat([c, k_pe], dim=-1)
    o_lat = mla.mla_decode_attention(q_lat, q_pe, cache, ok, T, scale)
    absorbed = torch.einsum("bhc,hvc->bhv", o_lat, w_uv)
    torch.testing.assert_close(absorbed, plain, rtol=1e-5, atol=1e-6)


def test_router_choice_and_weights():
    """The bias chooses, the sigmoid scores weigh: normalised, scaled."""
    g = torch.Generator().manual_seed(2)
    h = torch.randn(50, 16, generator=g)
    w = torch.randn(8, 16, generator=g) * 0.3
    s = torch.sigmoid(h @ w.t())
    bias = torch.zeros(8)
    bias[3] = 5.0  # expert 3 always chosen, whatever its score
    idx, wt = moe.route(h, w, bias, 2, 2.446)
    assert (idx == 3).any(dim=1).all()
    assert torch.equal(idx, torch.topk(s + bias, 2, dim=-1).indices)
    expect = s.gather(1, idx)
    expect = expect / expect.sum(1, keepdim=True) * 2.446
    torch.testing.assert_close(wt, expect)
    torch.testing.assert_close(wt.sum(1), torch.full((50,), 2.446))
    # without the bias the choice differs somewhere
    plain, _ = moe.route(h, w, torch.zeros(8), 2, 2.446)
    assert not torch.equal(plain, idx)
    # the shape of the input is kept: (B, L, d) -> (B, L, k)
    idx3, _ = moe.route(h.view(5, 10, 16), w, bias, 2, 1.0)
    assert idx3.shape == (5, 10, 2) and torch.equal(idx3.view(50, 2), idx)
    _, raw = moe.route(h, w, bias, 2, 1.0, normalize=False)
    torch.testing.assert_close(raw, s.gather(1, idx))


def _experts_tiled(h, idx, w, gate_up, down, block_m):
    """K10's arithmetic over ``moe.tile_rows``' layout, tile by tile in
    plain torch: each tile's rows through its expert, weighted, written to
    their (token, slot) places, then a token's k rows summed."""
    N, k = idx.shape
    M = N * k
    rows, tile_expert = moe.tile_rows(idx, gate_up.shape[0], block_m)
    out = torch.zeros((M, h.shape[1]), dtype=torch.float32)
    for t, e in enumerate(tile_expert.tolist()):
        if e < 0:
            continue
        r = rows[t * block_m:(t + 1) * block_m].long()
        r = r[r < M]
        g, u = torch.matmul(h[r // k], gate_up[e].t()).chunk(2, dim=-1)
        y = torch.matmul(torch.nn.functional.silu(g) * u, down[e].t())
        out[r] = y.float() * w.reshape(-1)[r, None]
    return out.view(N, k, -1).sum(dim=1)


@pytest.mark.parametrize("block_m", [4, 16])
def test_moe_experts_tiled_equals_the_loop(block_m):
    """The kernels' tiled layout (rows sorted by expert, each expert's run
    padded to whole tiles, each tile's expert found on the device) and
    their arithmetic tile by tile, against the loop over experts, with
    experts that no row chose."""
    g = torch.Generator().manual_seed(3)
    N, d, I, E, k = 40, 32, 24, 8, 3
    h = torch.randn(N, d, generator=g)
    idx = torch.stack([torch.randperm(5, generator=g)[:k] for _ in range(N)])
    w = torch.rand(N, k, generator=g)
    gate_up = torch.randn(E, 2 * I, d, generator=g) * 0.2
    down = torch.randn(E, d, I, generator=g) * 0.2
    rows, tile_expert = moe.tile_rows(idx, E, block_m)
    M = N * k
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    tiles = (counts + block_m - 1) // block_m
    assert tile_expert.numel() == -(-M // block_m) + E
    assert torch.equal(tile_expert[:int(tiles.sum())],
                       torch.repeat_interleave(torch.arange(E), tiles).int())
    assert (tile_expert[int(tiles.sum()):] == -1).all()
    real = rows[rows < M].long()
    assert torch.equal(torch.sort(real).values, torch.arange(M))
    for t, e in enumerate(tile_expert.tolist()):
        r = rows[t * block_m:(t + 1) * block_m].long()
        assert (idx.reshape(-1)[r[r < M]] == e).all()
    got = _experts_tiled(h, idx, w, gate_up, down, block_m)
    want = moe.moe_experts_reference(h, idx, w, gate_up, down)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    loop = torch.zeros(N, d)
    for n in range(N):
        for j in range(k):
            e = int(idx[n, j])
            gg, u = (gate_up[e] @ h[n]).chunk(2)
            loop[n] += w[n, j] * (down[e] @ (torch.nn.functional.silu(gg)
                                             * u))
    torch.testing.assert_close(want, loop, rtol=1e-5, atol=1e-5)
    assert torch.equal(moe.moe_experts(h, idx, w, gate_up, down), want)


def _generate(cfg, lm, prefix, ids, mask, steps):
    """lm_generate's ids and its logits at the prefill and every step."""
    logits = []
    head = moe_lm.lm_head

    def keep(x, weight):
        y = head(x, weight)
        logits.append(y)
        return y

    moe_lm.lm_head = keep
    try:
        out = moe_lm.lm_generate(lm, cfg, prefix, ids, mask, steps)
    finally:
        moe_lm.lm_head = head
    return out, torch.stack(logits, dim=1)


def test_prefill_and_20_steps_match_the_full_forward():
    """Prefill over [prefix || left-padded prompt] and 19 greedy steps
    through the latent cache give the logits of the reference's full
    forward over [prefix || prompt || served tokens], for rows of three
    prompt lengths."""
    cfg, lm = tiny_lm(4)
    g = torch.Generator().manual_seed(5)
    B, P, W, steps = 3, 5, 7, 20
    prefix = torch.randn(B, P, cfg.hidden_size, generator=g)
    lens = [7, 3, 5]
    ids = torch.zeros(B, W, dtype=torch.long)
    mask = torch.zeros(B, W, dtype=torch.long)
    for b, n in enumerate(lens):
        ids[b, :n] = torch.randint(2, cfg.vocab_size, (n,), generator=g)
        mask[b, :n] = 1
    out, port = _generate(cfg, lm, prefix, ids, mask, steps)
    assert out.shape == (B, 1 + steps) and port.shape[1] == steps
    assert (out[:, 0] == cfg.pad_token_id).all()
    w = named(lm)
    rows = [torch.cat([ids[b, :n], out[b, 1:steps].long()])
            for b, n in enumerate(lens)]
    embeds = [torch.cat([prefix[b], e])
              for b, e in enumerate(ref_lm.embed(w, rows))]
    chosen = [[] for _ in range(B)]
    with ref.exact_fp32():
        hidden, stats = ref_lm.forward_rows(w, dataclasses.asdict(cfg),
                                            embeds, chosen=chosen)
        at = torch.stack([h[P + n - 1:P + n - 1 + steps]
                          for h, n in zip(hidden, lens)])
        want = ref_lm.logits(w, at.flatten(0, 1)).view(B, steps, -1)
    err = (port - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) < 1e-5, float(err.max())
    assert torch.equal(out[:, 1:], want.argmax(-1).to(torch.int32))
    # the reference judging its own routes: nothing flips or exceeds
    with ref.exact_fp32():
        _, again = ref_lm.forward_rows(w, dataclasses.asdict(cfg), embeds,
                                       routes=chosen, route_tol=0.0)
    assert again["route_excess"] == 0 and again["route_flips"] == 0
    assert again["route_decisions"] == sum(
        P + n + steps - 1 for n in lens) * (cfg.num_hidden_layers - 1)


def test_route_excess_and_flips():
    """A program route below the reference's k-th by more than the
    tolerance counts; within it, the reference takes it."""
    cfg, lm = tiny_lm(6)
    w = named(lm)
    x = [torch.randn(6, cfg.hidden_size, generator=torch.Generator()
                     .manual_seed(7))]
    chosen = [[]]
    with ref.exact_fp32():
        ref_lm.forward_rows(w, dataclasses.asdict(cfg), x, chosen=chosen)
    wrong = [[r.clone() for r in chosen[0]]]
    # an expert not among the token's own: the top choice replaced
    e = int(wrong[0][0][0, 0])
    other = next(j for j in range(cfg.n_routed_experts)
                 if j not in wrong[0][0][0].tolist())
    wrong[0][0][0, 0] = other
    with ref.exact_fp32():
        _, strict = ref_lm.forward_rows(w, dataclasses.asdict(cfg), x,
                                        routes=wrong, route_tol=0.0)
        _, loose = ref_lm.forward_rows(w, dataclasses.asdict(cfg), x,
                                       routes=wrong, route_tol=1e3)
    assert e != other
    assert strict["route_excess"] == 1 and strict["route_flips"] == 0
    assert loose["route_excess"] == 0 and loose["route_flips"] == 1
    assert loose["flip_margin"] > 0


def _server_setup(**cfg_keys):
    splits, images = serving.synthetic_slake(10, 4, image_size=32, seed=0,
                                             n_validate=2)
    cfg = serving.synthetic_config(batch_size=4, epochs=1, retrieval=True,
                                   k=1, image_size=32)
    # wider than the CLIP tower's 64: the prefix goes through the projection
    cfg.update(generator="lm", lm_overrides={**TINY, "hidden_size": 96},
               **cfg_keys)
    exp = serving.ServingExperiment(
        cfg, train=splits["train"], validate=splits["validate"],
        test=splits["test"], images=images, device="cpu")
    return exp, splits, images


def test_server_answers_with_the_lm():
    exp, splits, images = _server_setup()
    assert exp.model_cfg.lm is not None and not hasattr(exp.params, "t5")
    assert exp.model_cfg.needs_projection
    srv = serve.MPRServer(exp, load_checkpoint=False, pipeline_depth=2)
    test = splits["test"]
    names = [e["image_name"] for e in test]
    uniq = list(dict.fromkeys(names))
    srv.stage_images(np.stack([images[n] for n in uniq]), uniq)
    answers = srv.answer(None, [e["question"] for e in test],
                         [e["task"] for e in test], image_ids=names)
    assert len(answers) == len(test) and all(isinstance(a, str)
                                             for a in answers)
    assert srv.chunks == {"fused": 3, "host": 0}
    assert 0 < srv.decode_steps <= 3 * 20
    # the same answers from the host-prompt path
    srv_host = serve.MPRServer(exp, load_checkpoint=False,
                               prompt_fastpath=False)
    srv_host.stage_images(np.stack([images[n] for n in uniq]), uniq)
    assert srv_host.answer(None, [e["question"] for e in test],
                           [e["task"] for e in test],
                           image_ids=names) == answers


@pytest.mark.parametrize("option", ["quantize", "spec_decode", "tp",
                                    "sharded_server"])
def test_lm_refuses_options(option, monkeypatch):
    """``quantize`` and ``spec_decode``: the server refuses them; a mesh
    (tp, the sharded server): the experiment, before any weight."""
    if option in ("tp", "sharded_server"):
        mesh = (pmesh.Mesh(n_model=2, rank=0) if option == "tp"
                else pmesh.Mesh(n_data=2, rank=0))
        monkeypatch.setattr(pmesh, "build_mesh", lambda cfg: mesh)
        with pytest.raises(ValueError, match=option):
            _server_setup()
        return
    exp, _, _ = _server_setup()
    kw = {"quantize": "int8"} if option == "quantize" else {"spec_decode": 4}
    with pytest.raises(ValueError, match=option):
        serve.MPRServer(exp, load_checkpoint=False, **kw)


@pytest.mark.parametrize("key", ["use_prediction_head", "t5_checkpoint"])
def test_experiment_refuses_with_the_lm(key):
    with pytest.raises(ValueError, match=key):
        _server_setup(**{key: 1 if key == "use_prediction_head"
                         else "t5.bin"})


def test_experiment_holds_the_lm_in_the_compute_dtype():
    exp, _, _ = _server_setup(compute_dtype="bfloat16")
    dtypes = {n: p.dtype for n, p in exp.params.lm.named_parameters()}
    assert all(dt == (torch.float32 if n.endswith("router_bias")
                      else torch.bfloat16) for n, dt in dtypes.items())
    assert exp.params.clip.text.token_embedding.dtype == torch.float32
    srv = serve.MPRServer(exp, load_checkpoint=False)
    # the serving copy shares the LM and casts the rest
    assert srv.params.lm is exp.params.lm
    assert srv.params.clip.text.token_embedding.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The benchmark's LM driver on the CPU
# ---------------------------------------------------------------------------

CELL = "kimi-vl-a3b.serve-pass"
TINY_CLIP = dict(embed_dim=64, image_resolution=32, vision_width=64,
                 vision_layers=2, patch_size=16, context_length=32,
                 vocab_size=514, text_width=64, vision_heads_override=2,
                 text_heads_override=2)
TINY_LIMITS = {"query_err": 1e-4, "search_excess": 0, "prefix_err": 1e-4,
               "logit_err": 1e-4, "token_excess": 0, "route_excess": 0,
               "route_flip_share": 0.0}


def tiny_registry(tmp_path, dtype: str = "float32"):
    from portbench.registry import HERE, Registry

    for d in ("configs", "workloads"):
        (tmp_path / d).mkdir(exist_ok=True)
    with open(os.path.join(HERE, "configs",
                           "kimi-vl-a3b_vit-b32.json")) as f:
        cfg = json.load(f)
    cfg.update({**TINY, "vocab_size": 4096})
    cfg["clip"].update(TINY_CLIP)
    cfg["settings"].update(batch_size=8, compute_dtype=dtype)
    (tmp_path / "configs" / "kimi-vl-a3b_vit-b32.json").write_text(
        json.dumps(cfg))
    with open(os.path.join(HERE, "workloads", CELL + ".json")) as f:
        wl = json.load(f)
    wl["traffic"].update(n_train=10, n_validate=2, n_test=8, image_size=32)
    wl["check"].update(decode_rows=6, limits=TINY_LIMITS)
    wl["driver_args"]["request_rows"] = 12
    (tmp_path / "workloads" / (CELL + ".json")).write_text(json.dumps(wl))
    return Registry(data=str(tmp_path))


@pytest.mark.parametrize("trace", [False, True])
def test_driver_cpu_run(tmp_path, trace, monkeypatch):
    from portbench import run

    # this suite's conftest loads jax; the run itself imports none of it
    monkeypatch.setattr(run, "banned_modules", lambda: [])
    reg = tiny_registry(tmp_path)
    out = run.run_cell(reg, CELL, 2 ** 31 + 11, 0.3, trace,
                       torch.device("cpu"), t0=0.0)
    stdout, stderr = io.StringIO(), io.StringIO()
    assert run.emit(out, stdout, stderr) == 0
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS)
    assert res["attempted"] > 0 and res["failed"] == 0
    if not trace:
        assert set(res["metrics"]) == {"serve_qa_per_s", "setup_s"}
    else:
        # the host-clock metric reads the program's spans; the device ones
        # need the card
        assert "lm.decode_ms_per_step" in res["metrics"]
        assert not {"moe.experts_roofline", "mla.decode_attention_roofline",
                    "lm.prefill_device_ms_per_chunk"} & set(res["metrics"])


def test_driver_bf16_fails_the_fp32_limits(tmp_path):
    """The same tiny cell computed in bf16 against limits that hold fp32
    to rounding: the check reads it as not correct."""
    from portbench import run

    reg = tiny_registry(tmp_path, "bfloat16")
    out = run.run_cell(reg, CELL, 5, 0.2, False, torch.device("cpu"), t0=0.0)
    out.pop("_ctx")
    assert out["correct"] is False
    assert out["checks"]["logit_err"]["value"] > 1e-4


@pytest.mark.parametrize("fault", ["bias_half", "router_bf16"])
def test_route_control_fails_the_flip_share(tmp_path, monkeypatch, fault):
    """The tiny cell in fp32 with a fault in the program's router
    (``portbench/lm_route_control.py``): its experts move among near ties,
    which the flip share counts, with no choice beyond ``route_tol``."""
    from portbench import lm_route_control, run

    monkeypatch.setattr(moe, "route", lm_route_control.fault(fault))
    reg = tiny_registry(tmp_path)
    out = run.run_cell(reg, CELL, 2 ** 31 + 11, 0.2, False,
                       torch.device("cpu"), t0=0.0)
    out.pop("_ctx")
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["route_flip_share"]["value"] > 0.0
    assert checks["route_excess"]["value"] == 0


# ---------------------------------------------------------------------------
# The card, at the cell's shapes
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# bf16: the kernel rounds the probabilities to bf16 for the second product
# (2^-9 relative) and sums in another order than the plain version's fp32
# over bf16 inputs; fp32: both in full fp32, sums in another order
_MLA_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.5e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 20, 114, 134])
def test_card_mla_decode_kernel(dtype, length):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(length)
    B, T, H, C, R = 512, 134, 16, 512, 64
    q = torch.randn(B, H, C, generator=g, device=dev).to(dtype)
    qp = torch.randn(B, H, R, generator=g, device=dev).to(dtype)
    cache = torch.randn(B, T, C + R, generator=g, device=dev).to(dtype)
    ok = (torch.rand(B, T, generator=g, device=dev) > 0.2).to(torch.int8)
    ok[:, 0] = 1
    scale = 192 ** -0.5
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = mla.mla_decode_attention(q, qp, cache, ok, length, scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = mla.mla_decode_attention_reference(q.float(), qp.float(),
                                              cache.float(), ok, length,
                                              scale)
    err = float(((got.float() - want).norm(dim=-1)
                 / want.norm(dim=-1)).max())
    assert err < _MLA_TOL[dtype], err


# fp32: full fp32 products summed in another order; bf16: the kernels
# round the SiLU product to bf16 (2^-9 relative) before the down product,
# the plain version runs fp32 over the same bf16 inputs
_MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [512, 4096])
def test_card_moe_experts(dtype, tokens):
    """3,072 rows (a decode step at B 512: tiles of 64 rows) and 24,576
    (tiles of 128) over 64 experts at the published widths, without a
    host sync."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(tokens)
    d, I, E, k = 2048, 1408, 64, 6
    h = (torch.randn(tokens, d, generator=g, device=dev)).to(dtype)
    gate_up = (torch.randn(E, 2 * I, d, generator=g, device=dev)
               * 0.02).to(dtype)
    down = (torch.randn(E, d, I, generator=g, device=dev) * 0.02).to(dtype)
    scores = torch.rand(tokens, E, generator=g, device=dev)
    idx = torch.topk(scores, k, dim=-1).indices
    w = torch.rand(tokens, k, generator=g, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.moe_experts(h, idx, w, gate_up, down)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = moe.moe_experts_reference(h.float(), idx, w, gate_up.float(),
                                     down.float())
    err = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    assert err < _MOE_TOL[dtype], err
