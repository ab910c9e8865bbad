"""The harness driven end to end on the CPU at tiny widths: the result
line, the check against the reference, a planted fault, the traffic and
the work counts.

The card runs the cells at full width; here every kernel takes its plain
version and no number lands under a device metric.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import pytest
import torch

from portbench import run, work
from portbench.registry import HERE, ROOT, Registry
from portbench.traffic import slake

CELL = "t5-small.serve-pass"
TINY_T5 = dict(vocab_size=4096, d_model=64, d_kv=16, d_ff=128, num_layers=2,
               num_decoder_layers=2, num_heads=4)
TINY_CLIP = dict(embed_dim=64, image_resolution=32, vision_width=64,
                 vision_layers=2, patch_size=16, context_length=32,
                 vocab_size=514, text_width=64, vision_heads_override=2,
                 text_heads_override=2)
# at float32 the program and the reference agree to rounding; these limits
# hold it to that, so bf16 compute or a changed token fails them
TINY_LIMITS = {"query_err": 1e-4, "search_excess": 0, "prefix_err": 1e-4,
               "logit_err": 1e-4, "token_excess": 0}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_registry(tmp_path, dtype: str = "float32") -> Registry:
    """The t5-small cell at tiny widths, in a data folder of their own."""
    for d in ("configs", "workloads"):
        (tmp_path / d).mkdir(exist_ok=True)
    with open(os.path.join(HERE, "configs", "t5-small_vit-b32.json")) as f:
        cfg = json.load(f)
    cfg["t5"].update(TINY_T5)
    cfg["clip"].update(TINY_CLIP)
    cfg["settings"].update(batch_size=8, compute_dtype=dtype)
    (tmp_path / "configs" / "t5-small_vit-b32.json").write_text(
        json.dumps(cfg))
    with open(os.path.join(HERE, "workloads", CELL + ".json")) as f:
        wl = json.load(f)
    wl["traffic"].update(n_train=10, n_validate=2, n_test=8, image_size=32)
    wl["check"].update(decode_rows=6, limits=TINY_LIMITS)
    wl["driver_args"]["request_rows"] = 12
    (tmp_path / "workloads" / (CELL + ".json")).write_text(json.dumps(wl))
    return Registry(data=str(tmp_path))


def tiny_run(tmp_path, trace=False, dtype="float32", seed=2 ** 31 + 7):
    reg = tiny_registry(tmp_path, dtype)
    return run.run_cell(reg, CELL, seed, 0.4, trace, torch.device("cpu"),
                        t0=0.0)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tmp_path, trace):
    cell = CELL
    out = tiny_run(tmp_path, trace)
    manifest = tiny_registry(tmp_path).manifest
    stdout, stderr = io.StringIO(), io.StringIO()
    assert run.emit(out, stdout, stderr) == 0
    lines = stdout.getvalue().strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    device_metrics = {m["name"] for m in manifest["per_layer"]
                      + manifest["end_to_end"]
                      if m["source"] == "device_trace" or "mfu" in m["name"]}
    assert not device_metrics & set(res["metrics"])
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) <= {m["name"] for m in manifest[kind]}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in manifest[
            "end_to_end"] if cell in m.get("workloads", [cell])}
    last = list(res["checks"])[-1]
    assert stderr.getvalue().strip().splitlines()[-1].startswith(
        f"check {last}:")


def test_reference_agrees_at_fp32_and_bf16_fails(tmp_path):
    reg = tiny_registry(tmp_path)
    out = run.run_cell(reg, CELL, 2 ** 31 + 7, 0.3, False,
                       torch.device("cpu"), control=True, t0=0.0)
    fp32 = out["_ctx"]["readings"]["program"]
    assert all(v <= TINY_LIMITS[k] for k, v in fp32.items()), fp32
    # the control, the reference with fp8 products in the program's place,
    # is what the run judges: it fails every limit it reads
    assert out["correct"] is False
    control = out["checks"]
    assert set(control) == {"query_err", "prefix_err", "logit_err"}
    assert all(c["value"] > 10 * c["limit"] for c in control.values()), \
        control
    bf16 = tiny_run(tmp_path, dtype="bfloat16")
    assert bf16["correct"] is False
    assert bf16["checks"]["query_err"]["value"] > 10 * TINY_LIMITS[
        "query_err"]


def test_a_token_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from multimodalpromptretrieval_tpu_torch.models import mprgen

    decode = mprgen.t5_greedy_decode

    def altered(*a, **kw):
        ids = decode(*a, **kw)
        ids[:, 3] = (ids[:, 3] + 1) % 100 + 2
        return ids

    monkeypatch.setattr(mprgen, "t5_greedy_decode", altered)
    out = tiny_run(tmp_path)
    assert out["correct"] is False
    assert out["checks"]["token_excess"]["value"] > 0


def test_traffic_follows_the_seed():
    params = {"n_train": 4, "n_validate": 1, "n_test": 3, "image_size": 32}
    a1, i1 = slake.generate(params, 2 ** 31 + 11)
    a2, i2 = slake.generate(params, 2 ** 31 + 11)
    b, j = slake.generate(params, 12)
    assert a1 == a2 and all(np.array_equal(i1[k], i2[k]) for k in i1)
    assert a1 != b or any(not np.array_equal(i1[k], j[k]) for k in i1)
    # every seed serves as many questions from the same templates
    assert [len(v) for v in a1.values()] == [len(v) for v in b.values()]


T5 = dict(d_model=8, d_kv=2, num_heads=2, d_ff=16, num_layers=1,
          num_decoder_layers=1, vocab_size=10, feed_forward_proj="relu")
CLIP = dict(image_resolution=4, patch_size=2, vision_width=4,
            vision_layers=1, embed_dim=3, text_width=4, text_layers=1)


def test_work_counts_by_hand():
    # encoder, one row of 3 tokens: q/k/v/o 4 * 2*3*8*4, scores and
    # products 4 * 3*3*4, FF 2 * 2*3*8*16
    assert work.t5_encoder_flops(T5, [3]) == 4 * 2 * 3 * 8 * 4 + 4 * 9 * 4 \
        + 2 * 2 * 3 * 8 * 16
    # padding is not work: rows of 3 and 1 tokens, not 2 rows of 3
    assert work.t5_encoder_flops(T5, [3, 1]) == (
        work.t5_encoder_flops(T5, [3]) + work.t5_encoder_flops(T5, [1]))
    # decode, one row, 2 steps over 5 encoder states: the self-attention
    # sees 1 then 2 tokens
    cross_kv = 2 * 2 * 5 * 8 * 4
    step = lambda t: (2 * 8 * 12 + 4 * (t + 1) * 4 + 2 * 4 * 8 + 2 * 8 * 4  # noqa: E731
                      + 4 * 5 * 4 + 2 * 4 * 8 + 2 * 2 * 8 * 16 + 2 * 8 * 10)
    assert work.t5_decode_flops(T5, [5], [2]) == cross_kv + step(0) + step(1)
    # a causal text row of 3 tokens: 6 query-key pairs
    layer = 2 * 3 * 4 * 16 + 4 * 6 * 4 + 2 * 3 * 4 * 16 + 2 * 3 * 16 * 4
    assert work.clip_text_flops(CLIP, [3]) == layer + 2 * 4 * 3
    # ViT over 2x2 patches + CLS = 5 tokens
    vit = 2 * 4 * 12 * 4 + (2 * 5 * 4 * 16 + 4 * 25 * 4 + 2 * 5 * 4 * 16
                            + 2 * 5 * 16 * 4) + 2 * 5 * 4 * 3
    assert work.vit_flops(CLIP, 1) == vit
    # a decode-attention call: 2 rows over 1 and 3 keys, bf16
    flops, nbytes = work.decode_attention_work(2, 4, [1, 3], 2)
    assert flops == 4 * 2 * 4 * 4
    assert nbytes == (2 * 2 * 8 + 2 * 4 * 8) * 2
    flops, nbytes = work.row_attention_work(2, 4, [3], 2, causal=True)
    assert flops == 4 * 6 * 8 and nbytes == 4 * 3 * 8 * 2

