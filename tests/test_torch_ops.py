"""The PyTorch port's ops against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function and its port;
the JAX Pallas kernels run as the JAX tests run them on the CPU (interpret
mode), the port's wrappers take their plain versions on CPU tensors. fp32
tolerances: 1e-5 absolute (different summation orders only); top-k
indices identical, ties included.

Tests marked ``cuda`` compare each hand-written kernel with its plain
version on the card and skip without one.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.models import t5 as jt5  # noqa: E402
from multimodalpromptretrieval_tpu.ops import (  # noqa: E402
    decode_attention as jdecode,
    layers as jlayers,
    norm as jnorm,
    row_attention as jrow,
    topk as jtopk,
)
from multimodalpromptretrieval_tpu_torch.models import t5 as pt5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    _build,
    decode_attention as pdecode,
    layers as players,
    norm as pnorm,
    row_attention as prow,
    topk as ptopk,
)

ATOL = 1e-5


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
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# ops/layers.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "quick_gelu",
                                "gelu_new", "dense"])
def test_layers_match_jax(fn):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    w = rng.normal(size=(40,)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    k = rng.normal(size=(40, 24)).astype(np.float32)  # JAX (in, out)
    kb = rng.normal(size=(24,)).astype(np.float32)
    if fn == "rms_norm":
        got, want = players.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w)
    elif fn == "layer_norm":
        got = players.layer_norm(_t(x), _t(w), _t(b))
        want = jlayers.layer_norm(x, w, b)
    elif fn == "dense":
        got = players.dense(_t(x), _t(k.T), _t(kb))
        want = jlayers.dense(x, k, kb)
    else:
        got = getattr(players, fn)(_t(x))
        want = getattr(jlayers, fn)(x)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# K2 / K3: fused norms (JAX Pallas kernel path: W % 128 == 0, rows >= 16)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", [(32, 128), (2, 25, 256)])
def test_fused_norms_match_jax_kernel(rms, shape):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    assert jnorm._supported(jnp.asarray(x))
    if rms:
        got = pnorm.fused_rms_norm(_t(x), _t(w))
        want = jnorm.fused_rms_norm(jnp.asarray(x), jnp.asarray(w))
    else:
        got = pnorm.fused_layer_norm(_t(x), _t(w), _t(b))
        want = jnorm.fused_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_fused_norm_bf16_rounds_before_affine():
    """Under bf16 the normalised row is rounded BEFORE the affine step:
    the port must agree with the JAX kernel to one bf16 ulp."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 128)).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    got = pnorm.fused_layer_norm(_t(x).bfloat16(), _t(w).bfloat16(),
                                 _t(b).bfloat16())
    want = jnorm.fused_layer_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(_np(got), want, atol=ulp, rtol=0)


# ---------------------------------------------------------------------------
# K1: packed row attention
# ---------------------------------------------------------------------------


def _attention_inputs(seed, B=3, L=12, H=4, Dh=16):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * H * Dh)).astype(np.float32)
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    mask = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    mask[:, 0] = 1
    return qkv, bias, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_row_attention_matches_jax_kernel(causal, with_bias, with_mask,
                                          scale):
    qkv, bias, mask = _attention_inputs(3)
    bias = bias if with_bias else None
    mask = mask if with_mask else None
    got = prow.row_attention_packed(
        _t(qkv), None if bias is None else _t(bias),
        None if mask is None else _t(mask), heads=4, scale=scale,
        causal=causal)
    want = jrow.row_attention_packed(
        jnp.asarray(qkv), None if bias is None else jnp.asarray(bias),
        None if mask is None else jnp.asarray(mask), heads=4, scale=scale,
        causal=causal, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


def test_row_attention_fully_masked_row_is_uniform():
    """-1e9 masking, not -inf: a row with every key masked averages V."""
    qkv, _, mask = _attention_inputs(4, B=2, L=8, H=2, Dh=16)
    mask[1] = 0
    got = prow.row_attention_packed(_t(qkv), None, _t(mask), heads=2,
                                    scale=1.0)
    want = jrow.row_attention_packed(jnp.asarray(qkv), None,
                                     jnp.asarray(mask), heads=2, scale=1.0,
                                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
    v = qkv[1, :, 2 * 32:]
    np.testing.assert_allclose(_np(got)[1], np.broadcast_to(
        v.mean(axis=0), v.shape), atol=2e-5)
    assert np.isfinite(_np(got)).all()


# ---------------------------------------------------------------------------
# K4: L2 top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("N", [37, 700])
def test_topk_matches_jax_kernel_with_ties(k, skip_first, N):
    """Small-integer embeddings make every distance exact, with many ties
    (duplicated corpus rows); N=700 pads the kernel's last 512-row block."""
    rng = np.random.default_rng(N + k)
    index = rng.integers(-2, 3, size=(N, 16)).astype(np.float32)
    index[N // 2:N // 2 + 5] = index[3]  # exact duplicates -> ties
    query = rng.integers(-2, 3, size=(9, 16)).astype(np.float32)
    query[0] = index[3]
    d, i = ptopk.l2_topk(_t(query), _t(index), k, skip_first=skip_first)
    jd, ji = jtopk.l2_topk(jnp.asarray(query), jnp.asarray(index), k,
                           impl="pallas_interpret", skip_first=skip_first)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL, rtol=0)
    assert i.dtype == torch.int32


def test_topk_random_matches_jax():
    rng = np.random.default_rng(5)
    index = rng.normal(size=(300, 64)).astype(np.float32)
    query = rng.normal(size=(12, 64)).astype(np.float32)
    sq = _t((index * index).sum(-1))
    d, i = ptopk.l2_topk(_t(query), _t(index), 15, index_sq=sq)
    jd, ji = jtopk.l2_topk(jnp.asarray(query), jnp.asarray(index), 15,
                           impl="pallas_interpret")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(d), _np(jd), atol=1e-4, rtol=0)


def _tie_inputs(B, N, D, seed):
    """Small-integer embeddings: every distance is exact in fp32 whatever
    the order of the sums, and duplicated corpus rows tie exactly."""
    rng = np.random.default_rng(seed)
    index = rng.integers(-2, 3, size=(N, D)).astype(np.float32)
    for dst, src in ((N // 2, 3), (N - 1, 0), (N // 3, N // 3 + 1)):
        index[dst] = index[src]
    query = rng.integers(-2, 3, size=(B, D)).astype(np.float32)
    query[0] = index[3]
    return query, index


@pytest.mark.parametrize("N,k", [(700, 32), (37, 32), (20, 20), (32, 32),
                                 (700, 64), (300, 128)])
@pytest.mark.parametrize("skip_first", [False, True])
def test_topk_matches_jax_kernel_at_largest_k_and_whole_corpus(N, k,
                                                               skip_first):
    """k of 32 and past it, and k == N, with ties; ``skip_first`` fetches
    one more, so it takes k - 1."""
    k = k - 1 if skip_first else k
    query, index = _tie_inputs(9, N, 16, seed=N + k)
    d, i = ptopk.l2_topk(_t(query), _t(index), k, skip_first=skip_first)
    jd, ji = jtopk.l2_topk(jnp.asarray(query), jnp.asarray(index), k,
                           impl="pallas_interpret", skip_first=skip_first)
    assert i.shape == (9, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Decode attention (plain) and T5 position buckets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_impl", ["reference", "indicator"])
def test_decode_attention_matches_jax(jax_impl):
    rng = np.random.default_rng(6)
    B, T, H, Dh = 4, 7, 4, 8
    q = rng.normal(size=(B, H * Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, H * Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, H * Dh)).astype(np.float32)
    bias = rng.normal(size=(H, T)).astype(np.float32)
    mask = rng.integers(0, 2, size=(B, T)).astype(np.int32)
    mask[:, 0] = 1
    fn = getattr(jdecode, f"decode_attention_{jax_impl}")
    for b_, m_ in ((bias, None), (None, mask)):
        got = pdecode.decode_attention_reference(
            _t(q), _t(k), _t(v), None if b_ is None else _t(b_),
            None if m_ is None else _t(m_), heads=H)
        want = fn(q, k, v, b_, m_, heads=H)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_relative_position_buckets_match_jax(bidirectional):
    rel = np.arange(-700, 700, dtype=np.int32)
    got = pt5.relative_position_bucket(
        _t(rel), bidirectional=bidirectional, num_buckets=32,
        max_distance=128)
    want = jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional=bidirectional, num_buckets=32,
        max_distance=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    _build.reset_launch_counts()
    qkv, bias, mask = _attention_inputs(7)
    prow.row_attention_packed(_t(qkv), _t(bias), _t(mask), heads=4,
                              scale=1.0)
    pnorm.fused_rms_norm(_t(qkv[0]), torch.ones(qkv.shape[-1]))
    ptopk.l2_topk(_t(qkv[0]), _t(qkv[1]), 2)
    assert set(_build.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ulp_bf16(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [5, 70])
def test_cuda_row_attention_kernel(dtype, causal, L):
    dev = _card()
    qkv, bias, mask = _attention_inputs(8, B=3, L=L, H=4, Dh=64)
    dt = getattr(torch, dtype)
    args = (_t(qkv).to(dev, dt), _t(bias).to(dev), _t(mask).to(dev))
    before = _build.launch_counts()["row_attention_packed"]
    got = prow.row_attention_packed(*args, heads=4, scale=0.5,
                                    causal=causal)
    want = prow.row_attention_packed_reference(*args, heads=4, scale=0.5,
                                               causal=causal)
    torch.cuda.synchronize()
    assert _build.launch_counts()["row_attention_packed"] == before + 1
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("width", [96, 512, 768])
def test_cuda_norm_kernels(dtype, rms, width):
    dev = _card()
    rng = np.random.default_rng(width)
    dt = getattr(torch, dtype)
    x = _t(rng.normal(size=(37, width)).astype(np.float32)).to(dev, dt)
    w = _t(rng.normal(size=(width,)).astype(np.float32)).to(dev, dt)
    b = _t(rng.normal(size=(width,)).astype(np.float32)).to(dev, dt)
    if rms:
        got, want = pnorm.fused_rms_norm(x, w), \
            pnorm.fused_rms_norm_reference(x, w)
    else:
        got, want = pnorm.fused_layer_norm(x, w, b), \
            pnorm.fused_layer_norm_reference(x, w, b)
    torch.cuda.synchronize()
    ref = _np(want)
    tol = 1e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("N", [37, 1230])
def test_cuda_topk_kernel(k, N):
    dev = _card()
    rng = np.random.default_rng(N)
    index = _t(rng.normal(size=(N, 1024)).astype(np.float32)).to(dev)
    query = _t(rng.normal(size=(65, 1024)).astype(np.float32)).to(dev)
    sq = torch.sum(index * index, dim=-1)
    d, i = ptopk.l2_topk(query, index, k, index_sq=sq)
    rd, ri = ptopk.l2_topk_reference(query, index, k, sq)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(i.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_allclose(_np(d), _np(rd), atol=1e-3, rtol=0)


def _topk_on_card(query, index, k, skip_first=False, atol=1e-3):
    dev = _card()
    query, index = _t(query).to(dev), _t(index).to(dev)
    sq = torch.sum(index * index, dim=-1)
    before = _build.launch_counts()["l2_topk"]
    d, i = ptopk.l2_topk(query, index, k, index_sq=sq, skip_first=skip_first)
    fetch = k + 1 if skip_first else k
    rd, ri = ptopk.l2_topk_reference(query, index, fetch, sq)
    if skip_first:
        rd, ri = rd[:, 1:], ri[:, 1:]
    torch.cuda.synchronize()
    assert _build.launch_counts()["l2_topk"] == before + 1
    assert i.dtype == torch.int32 and i.shape == (query.shape[0], k)
    np.testing.assert_array_equal(i.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_allclose(_np(d), _np(rd), atol=atol, rtol=0)
    return i.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 16, 32])
@pytest.mark.parametrize("D", [16, 1000, 1024])
@pytest.mark.parametrize("N", [37, 1230, 5000])
@pytest.mark.parametrize("B", [1, 65])
def test_cuda_topk_exact_ties_at_tile_edges(B, N, D, k):
    """B, N and D off the kernel's tiles (64 queries, 64 rows, 32 columns),
    on small-integer embeddings: exact distances with many ties, so the
    indices must equal the stable sort's, ties at the lower index."""
    query, index = _tie_inputs(B, N, D, seed=N + D + k)
    i = _topk_on_card(query, index, k, atol=1e-6)
    if k >= 2:  # query 0 is corpus row 3 and its copy at N // 2
        assert list(i[0, :2]) == [3, N // 2]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 15, 31])
@pytest.mark.parametrize("N", [37, 1230])
def test_cuda_topk_skip_first(N, k):
    query, index = _tie_inputs(65, N, 1024, seed=N + k)
    i = _topk_on_card(query, index, k, skip_first=True, atol=1e-6)
    assert i[0, 0] == N // 2  # the self-match, row 3, is dropped


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 1000, 1024])
@pytest.mark.parametrize("N,k", [(37, 16), (1230, 1), (1230, 32), (5000, 15)])
def test_cuda_topk_random_rows(N, k, D):
    """Normal embeddings (distances rounded, no exact ties)."""
    rng = np.random.default_rng(N + D)
    index = rng.normal(size=(N, D)).astype(np.float32)
    query = rng.normal(size=(65, D)).astype(np.float32)
    _topk_on_card(query, index, k)


@pytest.mark.cuda
def test_cuda_topk_whole_corpus_and_largest_k():
    """Any 1 <= k <= N, past 32 too, and the whole corpus in order; one
    past N raises."""
    for N, k in ((20, 20), (32, 32), (1, 1), (64, 32), (65, 32), (40, 33),
                 (130, 130), (1230, 33), (1230, 64), (1230, 128)):
        query, index = _tie_inputs(9, max(N, 4), 16, seed=N)
        _topk_on_card(query, index[:N], k, atol=1e-6)
    query, index = _tie_inputs(65, 1230, 1024, seed=3)
    i = _topk_on_card(query, index, 32, skip_first=True, atol=1e-6)
    assert i[0, 0] == 1230 // 2  # the self-match, row 3, is dropped
    dev = _card()
    query, index = (_t(x).to(dev) for x in _tie_inputs(9, 40, 16, seed=1))
    with pytest.raises(ValueError, match="k=21"):
        ptopk.l2_topk(query, index[:20], 21)
    with pytest.raises(ValueError, match="k=41"):
        ptopk.l2_topk(query, index, 40, skip_first=True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 64, 128])
def test_cuda_topk_past_32_at_full_width(k):
    """The serving shapes (512 queries, 1,230 rows of 1,024) with k past
    32, with and without the training-phase skip, on small-integer
    embeddings: exact distances, so the ranks are exact too. (Normal
    embeddings tie within an fp32 rounding deep in the ranking, where the
    kernel's and cuBLAS's sums may order two rows either way.)"""
    query, index = _tie_inputs(512, 1230, 1024, seed=k)
    for skip in (False, True):
        _topk_on_card(query, index, k, skip_first=skip, atol=1e-6)


# ---------------------------------------------------------------------------
# K1 / K5 at the kernels' tile edges
# ---------------------------------------------------------------------------

# the bf16 kernel works in tiles of 64 query rows and 64 keys (16-row and
# 16-key steps inside), the fp32 kernel in 32 rows and 64 keys
_EDGE_LENGTHS = [1, 7, 16, 17, 50, 63, 64, 65, 82, 127, 128, 129, 562]


def _edge_inputs(L, B=2, H=2, Dh=16, seed=11):
    qkv, bias, mask = _attention_inputs(seed, B=B, L=L, H=H, Dh=Dh)
    return qkv, bias, mask


def _masked_diagonal(mask, L):
    """A key mask that masks the diagonal of rows 0 and L // 2 of sequence 0
    and every key of the past of row L // 2: under causal its future keys
    (at s - 1e9) then weigh like its masked ones (at -1e9)."""
    mask = mask.copy()
    mask[0, :L // 2 + 1] = 0
    return mask


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("L", [63, 64, 65, 129])
def test_row_attention_plain_matches_jax_at_tile_edges(L, packed):
    """The plain versions the kernels are held to, against the JAX kernels
    in interpret mode at lengths around the tile sizes."""
    qkv, bias, mask = _edge_inputs(L)
    if packed:
        got = prow.row_attention_packed(_t(qkv), _t(bias), _t(mask), heads=2,
                                        scale=0.25, causal=True)
        want = jrow.row_attention_packed(
            jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), heads=2,
            scale=0.25, causal=True, interpret=True)
    else:
        q, k, v = np.split(qkv, 3, axis=-1)
        got = prow.row_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                 heads=2, scale=0.25)
        want = jrow.row_attention(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(bias),
            jnp.asarray(mask), heads=2, scale=0.25, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("L", [12, 65])
def test_row_attention_causal_with_masked_diagonal_matches_jax(L):
    """Causal ADDS -1e9 and the mask REPLACES with -1e9: a row whose whole
    past is masked spreads its weight over masked and future keys alike, so
    no future key may be dropped for it."""
    qkv, _, mask = _edge_inputs(L)
    mask = _masked_diagonal(mask, L)
    got = _np(prow.row_attention_packed(_t(qkv), None, _t(mask), heads=2,
                                        scale=0.25, causal=True))
    want = _np(jrow.row_attention_packed(
        jnp.asarray(qkv), None, jnp.asarray(mask), heads=2, scale=0.25,
        causal=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # row 0 of sequence 0: its masked diagonal at -1e9 and its unmasked
    # future keys at s - 1e9 == -1e9 weigh the same (a masked future key
    # sits at -2e9 and weighs nothing): the mean of V over those keys
    keep = mask[0] != 0
    keep[0] = True
    v = qkv[0, :, 2 * 32:]
    np.testing.assert_allclose(got[0, 0], v[keep].mean(axis=0), atol=2e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("L", [64, 129])
def test_row_attention_fully_masked_row_at_tile_edges(L):
    qkv, bias, mask = _edge_inputs(L)
    mask[1] = 0
    got = _np(prow.row_attention_packed(_t(qkv), _t(bias), _t(mask), heads=2,
                                        scale=1.0))
    want = _np(jrow.row_attention_packed(
        jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(mask), heads=2,
        scale=1.0, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    v = qkv[1, :, 2 * 32:]
    np.testing.assert_allclose(got[1], np.broadcast_to(
        v.mean(axis=0), v.shape), atol=2e-5)


@pytest.mark.parametrize("packed", [True, False])
def test_row_attention_bf16_bias_passes_through(packed):
    """The wrapper hands the bias on in the dtype it comes in: a bf16 bias
    gives the result of its exact fp32 upcast, at fp32 and bf16 inputs."""
    qkv, bias, mask = _edge_inputs(17)
    bias16 = _t(bias).bfloat16()
    for dt in (torch.float32, torch.bfloat16):
        x = _t(qkv).to(dt)
        if packed:
            fn = lambda b: prow.row_attention_packed(  # noqa: E731
                x, b, _t(mask), heads=2, scale=0.5, causal=True)
        else:
            q, k, v = x.split(x.shape[-1] // 3, dim=-1)
            fn = lambda b: prow.row_attention(  # noqa: E731
                q, k, v, b, _t(mask), heads=2, scale=0.5)
        got, want = fn(bias16), fn(bias16.float())
        assert got.dtype == dt
        assert torch.equal(got, want)
    assert bias16.dtype == torch.bfloat16


def _row_on_card(name, fn, plain, dtype):
    before = _build.launch_counts()[name]
    got, want = fn(), plain()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)
    assert np.isfinite(_np(got)).all()


def _row_max_len():
    return _build.library().mpr_row_attention_max_len(64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K1", "K1_causal", "K5"])
@pytest.mark.parametrize("L", _EDGE_LENGTHS + ["max"])
def test_cuda_row_attention_tile_edges(L, kernel, dtype):
    """K1 / K5 against their plain versions around every tile edge, with a
    bias in the inputs' dtype and a key mask."""
    dev = _card()
    L = _row_max_len() if L == "max" else L
    B = 1 if L > 600 else 3
    qkv, bias, mask = _attention_inputs(9, B=B, L=L, H=2, Dh=64)
    dt = getattr(torch, dtype)
    x, b_, m_ = _t(qkv).to(dev, dt), _t(bias).to(dev, dt), _t(mask).to(dev)
    if kernel == "K5":
        q, k, v = (t.contiguous() for t in x.split(128, dim=-1))
        kw = dict(heads=2, scale=0.125)
        _row_on_card("row_attention",
                     lambda: prow.row_attention(q, k, v, b_, m_, **kw),
                     lambda: prow.row_attention_reference(q, k, v, b_, m_,
                                                          **kw), dtype)
    else:
        kw = dict(heads=2, scale=0.125, causal=kernel == "K1_causal")
        _row_on_card(
            "row_attention_packed",
            lambda: prow.row_attention_packed(x, b_, m_, **kw),
            lambda: prow.row_attention_packed_reference(x, b_, m_, **kw),
            dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [16, 50, 129, 562])
def test_cuda_row_attention_causal_skips_only_future_keys(L, dtype):
    """Causal with neither mask nor bias (the CLIP text tower), where the
    kernel leaves out the keys after a tile's last row."""
    dev = _card()
    qkv, _, _ = _attention_inputs(10, B=2, L=L, H=2, Dh=64)
    x = _t(qkv).to(dev, getattr(torch, dtype))
    kw = dict(heads=2, scale=0.125, causal=True)
    _row_on_card("row_attention_packed",
                 lambda: prow.row_attention_packed(x, **kw),
                 lambda: prow.row_attention_packed_reference(x, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["masked_diagonal", "fully_masked_row"])
@pytest.mark.parametrize("L", [50, 65, 200])
def test_cuda_row_attention_masked_rows(L, case, dtype):
    """Causal with a key mask over a row's diagonal and whole past; a row
    with every key masked (uniform, finite)."""
    dev = _card()
    qkv, _, mask = _attention_inputs(12, B=2, L=L, H=2, Dh=64)
    if case == "masked_diagonal":
        mask = _masked_diagonal(mask, L)
    else:
        mask[1] = 0
    x, m_ = _t(qkv).to(dev, getattr(torch, dtype)), _t(mask).to(dev)
    kw = dict(heads=2, scale=0.125, causal=case == "masked_diagonal")
    _row_on_card("row_attention_packed",
                 lambda: prow.row_attention_packed(x, None, m_, **kw),
                 lambda: prow.row_attention_packed_reference(x, None, m_,
                                                             **kw), dtype)
    if case == "fully_masked_row":
        got = _np(prow.row_attention_packed(x, None, m_, **kw))
        v = _np(x)[1, :, 256:]
        tol = 2e-5 if dtype == "float32" else _ulp_bf16(v)
        np.testing.assert_allclose(got[1], np.broadcast_to(
            v.mean(axis=0), v.shape), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [17, 64, 130])
def test_cuda_row_attention_unaligned_column_slices(L, dtype):
    """K5 over column slices whose bases are not 16-byte aligned (an odd
    element offset into a wider tensor): no copy, the 2- or 4-byte load
    path."""
    dev = _card()
    rng = np.random.default_rng(13)
    W = 128
    wide = _t(rng.normal(size=(3, 2, L, W + 3)).astype(np.float32)).to(
        dev, getattr(torch, dtype))
    q, k, v = (wide[i, :, :, 1 + i:1 + i + W] for i in range(3))
    assert any(t.data_ptr() % 16 for t in (q, k, v))
    kw = dict(heads=2, scale=0.125)
    _row_on_card("row_attention",
                 lambda: prow.row_attention(q, k, v, **kw),
                 lambda: prow.row_attention_reference(q, k, v, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_row_attention_refuses_one_past_the_largest(dtype):
    dev = _card()
    L = _row_max_len() + 1
    assert L > 1024
    x = torch.zeros((1, L, 3 * 64), dtype=getattr(torch, dtype), device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        prow.row_attention_packed(x, heads=1, scale=1.0)
