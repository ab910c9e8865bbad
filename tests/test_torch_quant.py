"""The port's int8 W8A8 serving weights against the JAX package, on the CPU.

``ops/quant.py`` of both packages on the same numpy inputs: identical int8
payloads and scales, ``dense_q8`` within one ulp of the output dtype
(zero rows, bf16 included), the port's packed (3W, D) qkv equal to JAX's
``kconcat`` of q / k / v. The plan's scope on the port's model, the fp32
scales kept by the compute copy, the int8 server's answers equal to the
JAX int8 server's (the pair of ``tests/test_torch_serve.py``), retrieval
ranks under ``"int8"`` equal to full precision. On the card (``cuda``
marker): the library int8 GEMM against its exact plain version at the
decode shape and on a 16-row tail chunk.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.ops import quant as jquant  # noqa: E402
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.clip import CLIPConfig  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import quant as pquant  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402

from test_torch_serve import _config, _pair, _requests  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(ref, dtype):
    """One ulp of ``dtype`` at the output's largest magnitude."""
    mant = 23 if dtype == "float32" else 7
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - mant)


def _inputs(seed, M=16, K=64, N=48):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[3] = 0.0  # zero rows: scale eps, x_q = 0, y = bias
    x[11] = 0.0
    w = rng.normal(size=(N, K)).astype(np.float32)  # torch (out, in)
    b = rng.normal(size=(N,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dense_q8_match_jax(dtype):
    x, w, b = _inputs(0)
    jw = jquant.quantize_kernel(jnp.asarray(w.T))
    pw = pquant.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(pw.q8.numpy(), np.asarray(jw["q8"]).T)
    np.testing.assert_array_equal(pw.q_scale.numpy(),
                                  np.asarray(jw["q_scale"])[0])
    assert pw.q8.dtype == torch.int8 and pw.q_scale.dtype == torch.float32

    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jq, js = jquant.quantize_rows(jx)
    pq, ps = pquant.quantize_rows(tx)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))

    want = _np(jquant.dense_q8(jx, jw, jnp.asarray(b, jdt)))
    got = pquant.dense_q8(tx, pw, torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and got.shape == (16, 48)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=_ulp(want, dtype))
    np.testing.assert_array_equal(_np(got)[[3, 11]],
                                  np.broadcast_to(_np(torch.from_numpy(b)
                                                      .to(tdt)), (2, 48)))
    # the plain int8 product is exact: float64 holds every partial sum
    acc = pquant.int8_matmul_reference(pq, pw.q8).numpy()
    np.testing.assert_array_equal(
        acc, pq.numpy().astype(np.int64) @ pw.q8.numpy().T.astype(np.int64))


def test_packed_qkv_matches_jax_kconcat():
    """Quantizing the port's packed (3W, D) qkv gives JAX's ``kconcat`` of
    the quantized q, k, v, and the port's row slices give each one."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(32, 24)).astype(np.float32)
               for _ in range(3))  # JAX (in, out)
    want = jquant.kconcat([jquant.quantize_kernel(jnp.asarray(a))
                           for a in (q, k, v)], axis=1)
    packed = pquant.quantize_kernel(torch.from_numpy(
        np.concatenate([q.T, k.T, v.T])))
    np.testing.assert_array_equal(packed.q8.numpy(), np.asarray(want["q8"]).T)
    np.testing.assert_array_equal(packed.q_scale.numpy(),
                                  np.asarray(want["q_scale"])[0])
    part = packed[24:48]
    alone = pquant.quantize_kernel(torch.from_numpy(k.T.copy()))
    assert torch.equal(part.q8, alone.q8)
    assert torch.equal(part.q_scale, alone.q_scale)


def _tiny_model(compute_dtype="float32"):
    cfg = pmprgen.MPRGenConfig(
        t5=T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                    num_decoder_layers=2, num_heads=4,
                    feed_forward_proj="gated-gelu"),
        clip=CLIPConfig(embed_dim=32, image_resolution=32, vision_width=32,
                        vision_layers=2, patch_size=16, context_length=16,
                        vocab_size=64, text_width=32, text_layers=2,
                        vision_heads_override=2, text_heads_override=2),
        compute_dtype=compute_dtype)
    return cfg, pmprgen.init_mprgen(cfg, seed=0)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_plan_scope_and_compute_copy(mode):
    """T5's blocks only (``"int8"``), plus both CLIP towers' blocks
    (``"int8_all"``); the shared embedding, the norms and everything left
    alone are the masters' own tensors; the bf16 compute copy keeps the
    int8 payloads and fp32 scales."""
    cfg, params = _tiny_model("bfloat16")
    qp = pquant.quantize_params(params, t5=True, clip=mode == "int8_all")
    paths = set(pquant.quantized_paths(qp))
    t5 = {f"t5.{stack}.block.{i}.{name}"
          for stack, names in (
              ("encoder", ("attn.qkv", "attn.o.weight")),
              ("decoder", ("self_attn.qkv", "self_attn.o.weight",
                           "cross_attn.qkv", "cross_attn.o.weight")))
          for i in range(2) for name in names + (
              "ff.wi_0.weight", "ff.wi_1.weight", "ff.wo.weight")}
    clip = {f"clip.{tower}.blocks.{i}.{name}.weight"
            for tower in ("visual", "text") for i in range(2)
            for name in ("attn.qkv", "attn.out", "mlp.fc", "mlp.proj")}
    assert paths == (t5 | clip if mode == "int8_all" else t5)
    assert pquant.quantized_paths(params) == []  # the masters untouched
    assert qp.t5.shared is params.t5.shared
    assert qp.t5.encoder.block[0].attn_ln is params.t5.encoder.block[0].attn_ln
    if mode == "int8":
        assert (qp.clip.visual.blocks[0].attn.qkv.weight
                is params.clip.visual.blocks[0].attn.qkv.weight)

    cast = pmprgen.cast_compute(qp, cfg)
    weights = [getattr(m, a) for name in paths
               for m, a in [(cast.get_submodule(name.rsplit(".", 1)[0]),
                             name.rsplit(".", 1)[1])]]
    assert len(weights) == len(paths)
    assert all(w.q8.dtype == torch.int8 and w.q_scale.dtype == torch.float32
               for w in weights)
    assert cast.t5.shared.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_quant"))
    return _pair(root, _config(root, 3))


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_int8_server_answers_match_jax(pair, mode):
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    want = JServer(jexp, load_checkpoint=False, quantize=mode).answer(
        images, questions, tasks, image_ids=ids)
    server = MPRServer(pexp, load_checkpoint=False, quantize=mode)
    got = server.answer(images, questions, tasks, image_ids=ids)
    assert got == want
    assert server.chunks == {"fused": 3, "host": 0}
    assert any(a for a in got)


def test_int8_keeps_retrieval_ranks(pair):
    """``"int8"`` leaves the CLIP towers at full precision: the top-k of
    every chunk is the full-precision server's."""
    jexp, pexp = pair
    images, questions, tasks, ids = _requests(jexp)
    ranks = []
    for quantize in (None, "int8"):
        server = MPRServer(pexp, load_checkpoint=False, quantize=quantize)
        server.stage_images(images, ids)
        pos, emb, _ = server._staged
        with server._on_device():
            ranks.append(server._dispatch_all_retrieval(
                questions, emb, np.asarray([pos[i] for i in ids])))
    np.testing.assert_array_equal(ranks[0], ranks[1])


def test_unknown_quantize_mode_raises(pair):
    _, pexp = pair
    with pytest.raises(ValueError, match="unknown quantize mode"):
        MPRServer(pexp, load_checkpoint=False, quantize="int4")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [512, 16])
def test_cuda_dense_q8_matches_exact_plain(rows):
    """The card's int8 GEMM (``torch._int_mm``, rows padded past its shape
    checks) against the exact float64 product, at the decode step's qkv
    shape (512 x 512 -> 1,536) and on a 16-row tail chunk: identical int32
    accumulators, quantized rows and weights, and outputs (fp32, bf16) of
    the card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(size=(rows, 512)).astype(np.float32))
    w = pquant.quantize_kernel(torch.from_numpy(
        rng.normal(size=(1536, 512)).astype(np.float32)))
    dev = torch.device("cuda")
    wd = pquant.QWeight(w.q8.to(dev), w.q_scale.to(dev))
    xq, _ = pquant.quantize_rows(x)
    acc = pquant.int8_matmul(xq.to(dev), wd.q8)
    assert acc.dtype == torch.int32 and acc.shape == (rows, 1536)
    assert torch.equal(acc.cpu(), pquant.int8_matmul_reference(xq, w.q8))
    for dt in (torch.float32, torch.bfloat16):
        for got, want in zip(pquant.quantize_rows(x.to(dev, dt)),
                             pquant.quantize_rows(x.to(dt))):
            assert torch.equal(got.cpu(), want)
        got = pquant.dense_q8(x.to(dev, dt), wd)
        assert torch.equal(got.cpu(), pquant.dense_q8(x.to(dt), w))
    raw = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32))
    on_card, on_cpu = pquant.quantize_kernel(raw.to(dev)), \
        pquant.quantize_kernel(raw)
    assert torch.equal(on_card.q8.cpu(), on_cpu.q8)
    assert torch.equal(on_card.q_scale.cpu(), on_cpu.q_scale)

