"""The port's decode attention (K6, K7) and flash attention (K8) against the
JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function and its port.
The JAX Pallas kernels run in interpret mode; the port's wrappers take their
plain versions on CPU tensors. Tolerances: fp32 1e-5 absolute (summation
order only); bf16 one bf16 ulp of the output's scale (2^(floor(log2
max|ref|) - 7)), since ``exp`` and sums round differently in the two
frameworks.

Tests marked ``cuda`` compare each kernel with its plain version on the card
and skip without one.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.ops import (  # noqa: E402
    attention as jattn,
    decode_attention as jdecode,
)
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    _build,
    attention as pattn,
    decode_attention as pdecode,
    row_attention as prow,
)

ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ulp_bf16(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _tol(dtype, ref):
    return ATOL if dtype == "float32" else _ulp_bf16(ref)


# ---------------------------------------------------------------------------
# K6 / K7: decode-step attention
# ---------------------------------------------------------------------------


def _decode_inputs(seed, B=8, T=24, H=4, Dh=32):
    rng = np.random.default_rng(seed)
    W = H * Dh
    q = rng.normal(size=(B, W)).astype(np.float32)
    k = rng.normal(size=(B, T, W)).astype(np.float32)
    v = rng.normal(size=(B, T, W)).astype(np.float32)
    bias = rng.normal(size=(H, T)).astype(np.float32)
    mask = rng.integers(0, 2, size=(B, T)).astype(np.int32)
    mask[:, 0] = 1  # at least one valid key per row
    return q, k, v, bias, mask


_DECODE = {  # port wrapper, JAX Pallas kernel, JAX function it computes
    "K6": (pdecode.decode_attention, jdecode.decode_attention,
           jdecode.decode_attention_reference),
    "K7": (pdecode.decode_attention_fused, jdecode.decode_attention_fused,
           jdecode.decode_attention_indicator),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_decode_attention_matches_jax_kernels(kernel, with_mask, with_bias,
                                              dtype):
    q, k, v, bias, mask = _decode_inputs(0)
    bias = bias if with_bias else None
    mask = mask if with_mask else None
    scale = 0.5 if with_bias and with_mask else 1.0
    jdt, tdt = DTYPES[dtype]
    port, jkernel, jfn = _DECODE[kernel]
    got = port(*(_t(x).to(tdt) for x in (q, k, v)), _t(bias), _t(mask),
               heads=4, scale=scale)
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v)] + [_j(bias), _j(mask)]
    for name, want in (
            ("pallas kernel", jkernel(*jargs, heads=4, scale=scale,
                                      interpret=True)),
            ("function", jfn(*jargs, heads=4, scale=scale))):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, atol=_tol(dtype, want),
                                   rtol=0, err_msg=name)
    assert got.dtype == tdt and got.shape == q.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_decode_attention_writes_into_out(kernel, dtype):
    """``out=``: the result written into the given (B, W) tensor, which is
    returned, bit-equal to a new result; a tensor of another shape or
    dtype, or not contiguous, is refused."""
    q, k, v, bias, mask = _decode_inputs(0)
    tdt = DTYPES[dtype][1]
    port = _DECODE[kernel][0]
    args = [_t(x).to(tdt) for x in (q, k, v)] + [_t(bias), _t(mask)]
    want = port(*args, heads=4)
    out = torch.full_like(want, float("nan"))
    assert port(*args, heads=4, out=out) is out
    assert torch.equal(out, want)
    for bad in (out[:, :-1], out.float() if dtype != "float32"
                else out.bfloat16(), out.t().contiguous().t()):
        with pytest.raises(ValueError, match="out"):
            port(*args, heads=4, out=bad)


def test_indicator_decode_attention_matches_jax_at_bf16():
    """The JAX default ``decode_attention_impl="indicator"`` rounds each q*k
    product to bf16 before the fp32 sum. The port's decode attention under
    that name agrees to one bf16 ulp; the reference function (fp32
    products, K6's) misses by about three."""
    q, k, v, bias, mask = _decode_inputs(0)
    args = [x.astype(jnp.bfloat16) for x in map(jnp.asarray, (q, k, v))]
    want = _np(jdecode.decode_attention_indicator(*args, jnp.asarray(bias),
                                                  jnp.asarray(mask), heads=4))
    targs = [_t(x).bfloat16() for x in (q, k, v)] + [_t(bias), _t(mask)]
    got = _np(pdecode.decode_attention_for("indicator")(*targs, heads=4))
    ulp = _ulp_bf16(want)
    np.testing.assert_allclose(got, want, atol=ulp, rtol=0)
    reference = _np(pdecode.decode_attention_reference(*targs, heads=4))
    assert np.abs(reference - want).max() > 2 * ulp


def test_decode_attention_for_maps_the_jax_names():
    for impl in ("indicator", "fused"):
        assert pdecode.decode_attention_for(impl) is \
            pdecode.decode_attention_fused
    for impl in ("pallas", "xla"):
        assert pdecode.decode_attention_for(impl) is pdecode.decode_attention
    with pytest.raises(ValueError, match="decode_attention_impl"):
        pdecode.decode_attention_for("row")


# ---------------------------------------------------------------------------
# K8: flash attention
# ---------------------------------------------------------------------------


def _mha_inputs(seed, B, H, Lq, Lk, Dh, bias_shape=None, with_mask=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, Dh)).astype(np.float32)
    bias = (None if bias_shape is None else
            rng.normal(size=bias_shape + (Lq, Lk)).astype(np.float32))
    mask = None
    if with_mask:
        mask = rng.integers(0, 2, size=(B, Lk)).astype(np.int32)
        mask[:, 0] = 1
    return q, k, v, bias, mask


# B, H, Lq, Lk, bias broadcast shape, mask, causal, (block_q, block_k)
_FLASH_CASES = {
    "bias_BH_mask": (2, 4, 50, 50, (2, 4), True, False, None),
    "bias_1H": (2, 4, 50, 50, (1, 4), False, False, None),
    "bias_B1_mask": (3, 2, 20, 37, (3, 1), True, False, None),
    "bias_11_mask_causal_blocks": (3, 2, 20, 37, (1, 1), True, True, (8, 32)),
    "causal_long": (1, 2, 150, 150, None, False, True, None),
    "ragged_lq_blocks": (2, 2, 13, 200, (1, 2), True, False, (8, 32)),
    "causal_skip_blocks": (2, 3, 45, 70, (2, 3), True, True, (8, 32)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_flash_attention_matches_jax_kernel(case, dtype):
    B, H, Lq, Lk, bshape, with_mask, causal, blocks = _FLASH_CASES[case]
    q, k, v, bias, mask = _mha_inputs(1, B, H, Lq, Lk, 32, bshape, with_mask)
    blk = {} if blocks is None else dict(block_q=blocks[0],
                                         block_k=blocks[1])
    jdt, tdt = DTYPES[dtype]
    want = _np(jattn._flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), _j(bias), _j(mask),
        causal=causal, scale=0.3, interpret=True, **blk))
    got = pattn.flash_attention(*(_t(x).to(tdt) for x in (q, k, v)),
                                _t(bias), _t(mask), causal=causal, scale=0.3,
                                **blk)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(_np(got), want, atol=_tol(dtype, want),
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_rounds_unnormalised_p_like_the_kernel(causal):
    """Where the bf16 probabilities are rounded decides the output's last
    bit: the port stays within a quarter ulp of the JAX kernel (exp and
    summation order), while the row kernels' rounding of the NORMALISED p
    moves it by half an ulp or more (T5's scale 1.0, sharp softmax)."""
    B, H, L, Dh = (2, 4, 50, 32) if not causal else (1, 2, 300, 32)
    q, k, v, _, _ = _mha_inputs(1, B, H, L, L, Dh)
    want = _np(jattn._flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        scale=1.0, interpret=True))
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    got = _np(pattn.flash_attention(tq, tk, tv, causal=causal, scale=1.0))
    ulp = _ulp_bf16(want)
    np.testing.assert_allclose(got, want, atol=ulp / 4, rtol=0)
    qkv = torch.cat([x.transpose(1, 2).reshape(B, L, H * Dh)
                     for x in (tq, tk, tv)], dim=-1)
    row = prow.row_attention_packed_reference(qkv, heads=H, scale=1.0,
                                              causal=causal)
    row = _np(row.reshape(B, L, H, Dh).transpose(1, 2))
    assert np.abs(row - want).max() >= ulp / 2


def test_flash_fully_masked_row_counts_padded_keys():
    """A row with every key masked: the TPU kernel's running sum counts
    the padded tail keys too, so it averages V over the padded length (not
    over Lk, as the XLA path does); the plain version replays that."""
    q, k, v, _, mask = _mha_inputs(2, 2, 2, 9, 70, 16, with_mask=True)
    mask[1] = 0
    want = _np(jattn._flash_attention(
        *map(jnp.asarray, (q, k, v)), None, jnp.asarray(mask),
        block_k=32, interpret=True))
    got = _np(pattn.flash_attention(*map(_t, (q, k, v)), None, _t(mask),
                                    block_k=32))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    padded = v[1].sum(axis=1) / 96  # 70 keys in 3 blocks of 32
    np.testing.assert_allclose(got[1], np.broadcast_to(
        padded[:, None], got[1].shape), atol=ATOL)


def test_flash_blocks_are_the_jax_clamps():
    assert pattn.flash_blocks(50, 50) == (64, 128)
    assert pattn.flash_blocks(16, 16) == (16, 128)
    assert pattn.flash_blocks(82, 82) == (128, 128)
    assert pattn.flash_blocks(562, 562) == (512, 1024)
    assert pattn.flash_blocks(4096, 4096) == (512, 1024)
    assert pattn.flash_blocks(13, 200, 8, 32) == (8, 32)


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto",
                                  "pallas_interpret"])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax_fp32(impl, causal):
    q, k, v, bias, mask = _mha_inputs(3, 2, 4, 24, 24, 16, (1, 4), True)
    jimpl = "xla" if impl == "xla" else "pallas_interpret"
    want = jattn.multi_head_attention(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias),
        kv_mask=jnp.asarray(mask).astype(bool), causal=causal, scale=None,
        impl=jimpl)
    got = pattn.multi_head_attention(*map(_t, (q, k, v)), bias=_t(bias),
                                     kv_mask=_t(mask), causal=causal,
                                     impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_multi_head_attention_matches_jax_at_bf16(impl):
    """At bf16 ``"xla"`` rounds the scores and ``"pallas"`` the unnormalised
    per-block probabilities: the port matches each to one bf16 ulp. The
    row-kernel math (fp32 scores, ``"row"``) misses ``"xla"`` by several
    ulps (T5's scale 1.0 and bias, where the scores are large)."""
    B, H, L, Dh = 2, 4, 50, 32
    q, k, v, bias, mask = _mha_inputs(4, B, H, L, L, Dh, (1, H), True)
    jimpl = "xla" if impl == "xla" else "pallas_interpret"
    want = _np(jattn.multi_head_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        bias=jnp.asarray(bias), kv_mask=jnp.asarray(mask).astype(bool),
        scale=1.0, impl=jimpl))
    tq, tk, tv = (_t(x).bfloat16() for x in (q, k, v))
    got = _np(pattn.multi_head_attention(tq, tk, tv, bias=_t(bias),
                                         kv_mask=_t(mask), scale=1.0,
                                         impl=impl))
    ulp = _ulp_bf16(want)
    np.testing.assert_allclose(got, want, atol=ulp, rtol=0)
    if impl == "xla":
        qkv = torch.cat([x.transpose(1, 2).reshape(B, L, H * Dh)
                         for x in (tq, tk, tv)], dim=-1)
        row = prow.row_attention_packed_reference(
            qkv, _t(bias[0]), _t(mask), heads=H, scale=1.0)
        row = _np(row.reshape(B, L, H, Dh).transpose(1, 2))
        assert np.abs(row - want).max() > 2 * ulp


def test_multi_head_attention_refuses_unknown_impl():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="attention impl"):
        pattn.multi_head_attention(q, q, q, impl="row")


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_versions_and_count_nothing():
    _build.reset_launch_counts()
    q, k, v, bias, mask = _decode_inputs(5)
    pdecode.decode_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                             heads=4)
    pdecode.decode_attention_fused(_t(q), _t(k), _t(v), _t(bias), _t(mask),
                                   heads=4)
    q, k, v, bias, mask = _mha_inputs(5, 2, 2, 8, 8, 16, (1, 2), True)
    pattn.flash_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask))
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


def _check_on_card(name, fn, plain, dtype):
    before = _build.launch_counts()[name]
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)


# B, H, T, "self" (q a column slice of the qkv rows, the (H, T) bias) or
# "cross" (the key mask), scale, a row with every key masked. A warp of the
# kernel takes one (row, head), four warps a block from 1,024 pairs on
# ("ragged_*": 1,027 pairs). It walks the keys in tiles of 24 (bf16) or 12
# (fp32) rows: in bf16 up to 32 keys from device memory, past that through
# a ring of 2 tiles, past 56,576 keys from device memory again; in fp32
# from device memory at every T.
_CUDA_DECODE_CASES = {
    "self": (64, 8, 20, "self", 1.0, False),
    "cross": (64, 8, 82, "cross", 1.0, False),
    "t5_large_self": (128, 16, 20, "self", 1.0, False),
    "t5_large_cross": (128, 16, 114, "cross", 1.0, False),
    "batch_one": (1, 8, 82, "cross", 1.0, False),
    "one_key": (4, 8, 1, "self", 1.0, False),
    "direct_tile_below": (4, 8, 23, "cross", 1.0, False),
    "direct_tile_at": (4, 8, 24, "self", 1.0, False),
    "direct_tile_above": (4, 8, 25, "cross", 1.0, False),
    "direct_longest": (4, 8, 32, "self", 1.0, False),
    "ring_shortest": (4, 8, 33, "cross", 1.0, False),
    "tile_below": (4, 8, 47, "cross", 1.0, False),
    "tile_at": (4, 8, 48, "cross", 1.0, False),
    "tile_above": (4, 8, 49, "self", 1.0, False),
    "ring_wraps": (4, 16, 200, "cross", 1.0, False),
    "ragged_blocks": (79, 13, 40, "cross", 1.0, False),
    "ragged_direct": (79, 13, 20, "self", 1.0, False),
    "all_masked": (4, 8, 82, "cross", 1.0, True),
    "all_masked_direct": (4, 8, 20, "cross", 1.0, True),
    "scale": (4, 8, 82, "self", 0.125, False),
    "longest_ring": (2, 2, 56576, "cross", 1.0, False),
    "max_len": (2, 2, 58112, "cross", 1.0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CUDA_DECODE_CASES))
@pytest.mark.parametrize("kernel", ["K6", "K7"])
def test_cuda_decode_attention_kernels(kernel, case, dtype):
    """K6 / K7 on the card against their plain versions: the decode loop's
    shapes (t5-small's 8 heads, t5-large's 16), a batch of one, T at the
    key tile's edges, past the ring and at the longest T the kernel takes,
    a fully masked row (uniform probabilities) and scale != 1. T5's head
    dim 64."""
    dev = _card()
    tdt = DTYPES[dtype][1]
    B, H, T, kind, scale, masked_row = _CUDA_DECODE_CASES[case]
    q, k, v, bias, mask = _decode_inputs(6, B=B, T=T, H=H, Dh=64)
    if masked_row:
        mask[1] = 0
    W = H * 64
    qkv = torch.randn((B, 3 * W), generator=torch.Generator().manual_seed(0))
    qkv[:, :W] = _t(q)
    qkv = qkv.to(dev, tdt)
    qd = qkv[:, :W]
    kd, vd = (_t(x).to(dev, tdt) for x in (k, v))
    b_, m_ = ((_t(bias).to(dev), None) if kind == "self"
              else (None, _t(mask).to(dev)))
    name = ("decode_attention" if kernel == "K6"
            else "decode_attention_fused")
    fn = getattr(pdecode, name)
    plain = (pdecode.decode_attention_reference if kernel == "K6"
             else pdecode.decode_attention_indicator_reference)
    _check_on_card(name, lambda: fn(qd, kd, vd, b_, m_, heads=H, scale=scale),
                   lambda: plain(qd, kd, vd, b_, m_, heads=H, scale=scale),
                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention",
                                    "decode_attention_fused"])
def test_cuda_decode_attention_refuses_past_max_len(kernel):
    """One key past ``mpr_decode_attention_max_len`` raises before any
    launch; the longest T is the same at every head count."""
    dev = _card()
    lib = _build.library()
    max_len = lib.mpr_decode_attention_max_len(2)
    assert {lib.mpr_decode_attention_max_len(h) for h in (1, 8, 16, 32)} \
        == {max_len}
    B, H, T = 1, 2, max_len + 1
    q = torch.zeros((B, H * 64), device=dev)
    k = torch.zeros((B, T, H * 64), device=dev)
    before = _build.launch_counts()[kernel]
    with pytest.raises(ValueError, match="exceeds"):
        getattr(pdecode, kernel)(q, k, k, heads=H)
    assert _build.launch_counts()[kernel] == before


# B, H, L, scale, causal, bias and mask, (block_q, block_k)
_CUDA_FLASH_CASES = {
    "vit": (4, 12, 50, 0.125, False, False, None),
    "text": (4, 8, 16, 0.125, True, False, None),
    "t5_enc": (4, 8, 82, 1.0, False, True, None),
    "causal_blocks": (1, 2, 600, 1.0, True, True, (64, 128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CUDA_FLASH_CASES))
def test_cuda_flash_attention_kernel(case, dtype):
    """q/k/v are the (B, H, L, 64) head views of one packed QKV tensor."""
    dev = _card()
    tdt = DTYPES[dtype][1]
    B, H, L, scale, causal, with_bias, blocks = _CUDA_FLASH_CASES[case]
    q, k, v, bias, mask = _mha_inputs(7, B, H, L, L, 64,
                                      (1, H) if with_bias else None,
                                      with_bias)
    qkv = torch.stack([_t(x).transpose(1, 2) for x in (q, k, v)], dim=2)
    qkv = qkv.contiguous().to(dev, tdt)  # (B, L, 3, H, 64)
    qd, kd, vd = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    b_ = None if bias is None else _t(bias).to(dev)
    m_ = None if mask is None else _t(mask).to(dev)
    blk = {} if blocks is None else dict(block_q=blocks[0],
                                         block_k=blocks[1])
    kw = dict(causal=causal, scale=scale, **blk)
    _check_on_card(
        "flash_attention",
        lambda: pattn.flash_attention(qd, kd, vd, b_, m_, **kw),
        lambda: pattn.flash_attention_reference(qd, kd, vd, b_, m_, **kw),
        dtype)


# ---------------------------------------------------------------------------
# K8 at the kernel's tile edges
# ---------------------------------------------------------------------------

_EDGE_LENGTHS = [1, 7, 16, 17, 50, 63, 64, 65, 82, 127, 128, 129, 562]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", [63, 64, 65, 129])
def test_flash_plain_matches_jax_at_tile_edges(L, causal):
    """The plain version the kernel is held to, against the JAX kernel in
    interpret mode at lengths around the CUDA kernel's 64-row tiles, with a
    bias, a key mask and two key blocks at L=129."""
    q, k, v, bias, mask = _mha_inputs(8, 2, 2, L, L, 16, (1, 2), True)
    want = _np(jattn._flash_attention(
        *map(jnp.asarray, (q, k, v)), _j(bias), _j(mask), causal=causal,
        scale=0.25, block_k=128, interpret=True))
    got = _np(pattn.flash_attention(*map(_t, (q, k, v)), _t(bias), _t(mask),
                                    causal=causal, scale=0.25, block_k=128))
    np.testing.assert_allclose(got, want, atol=_tol("float32", want), rtol=0)


@pytest.mark.parametrize("L", [20, 65])
def test_flash_causal_with_masked_diagonal_matches_jax(L):
    """Sequence 0 masks keys 0..L/2: rows up to L/2 have no valid key at
    all (mask and causal both REPLACE with -1e9 here), so they average V
    over the padded key block."""
    q, k, v, _, mask = _mha_inputs(9, 2, 2, L, L, 16, with_mask=True)
    mask[0, :L // 2 + 1] = 0
    want = _np(jattn._flash_attention(
        *map(jnp.asarray, (q, k, v)), None, _j(mask), causal=True,
        interpret=True))
    got = _np(pattn.flash_attention(*map(_t, (q, k, v)), None, _t(mask),
                                    causal=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[0, :, 0], v[0].sum(axis=1) / 128,
                               atol=ATOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("L", [64, 129])
def test_flash_fully_masked_row_at_tile_edges(L):
    q, k, v, _, mask = _mha_inputs(10, 2, 2, L, L, 16, with_mask=True)
    mask[1] = 0
    want = _np(jattn._flash_attention(
        *map(jnp.asarray, (q, k, v)), None, _j(mask), block_k=128,
        interpret=True))
    got = _np(pattn.flash_attention(*map(_t, (q, k, v)), None, _t(mask),
                                    block_k=128))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all()


def _flash_on_card(dev, dtype, q, k, v, bias, mask, **kw):
    """K8 on (B, H, L, 64) head views of (B, L, H, 64) rows against its
    plain version."""
    tdt = DTYPES[dtype][1]
    qd, kd, vd = (_t(x).transpose(1, 2).contiguous().to(dev, tdt)
                  .transpose(1, 2) for x in (q, k, v))
    b_ = None if bias is None else _t(bias).to(dev)
    m_ = None if mask is None else _t(mask).to(dev)
    _check_on_card(
        "flash_attention",
        lambda: pattn.flash_attention(qd, kd, vd, b_, m_, **kw),
        lambda: pattn.flash_attention_reference(qd, kd, vd, b_, m_, **kw),
        dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L", _EDGE_LENGTHS)
def test_cuda_flash_attention_tile_edges(L, causal, dtype):
    dev = _card()
    q, k, v, bias, mask = _mha_inputs(11, 2, 2, L, L, 64, (1, 2), True)
    _flash_on_card(dev, dtype, q, k, v, bias, mask, causal=causal,
                   scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [16, 50, 129, 600, 1100])
def test_cuda_flash_attention_causal_trims_only_future_keys(L, dtype):
    """Causal with neither mask nor bias, where the kernel leaves out the
    keys after a tile's last row; L=1100 runs two default key blocks."""
    dev = _card()
    q, k, v, _, _ = _mha_inputs(12, 1, 2, L, L, 64)
    _flash_on_card(dev, dtype, q, k, v, None, None, causal=True,
                   scale=0.125)


# B, H, Lq, Lk, bias broadcast shape, mask, causal, (block_q, block_k)
_CUDA_FLASH_EDGE_CASES = {
    "lq_lt_lk": (2, 2, 13, 200, (1, 2), True, False, None),
    "lq_gt_lk": (2, 2, 150, 37, (2, 2), True, False, None),
    "blocks_128_over_300": (2, 2, 300, 300, (1, 2), True, False, (64, 128)),
    "blocks_128_over_300_causal": (2, 2, 300, 300, (1, 2), True, True,
                                   (64, 128)),
    "blocks_causal_no_mask": (1, 2, 300, 300, None, False, True, (8, 128)),
    "ragged_last_block": (2, 2, 70, 130, None, True, False, (8, 128)),
    "block_k_1024": (1, 2, 100, 1500, (1, 1), True, False, None),
    "bias_BH": (3, 2, 50, 50, (3, 2), False, False, None),
    "bias_1H": (3, 2, 50, 50, (1, 2), False, False, None),
    "bias_B1": (3, 2, 50, 50, (3, 1), False, False, None),
    "bias_11": (3, 2, 50, 50, (1, 1), False, False, None),
    "masked_diagonal_causal": (2, 2, 65, 65, None, "diagonal", True, None),
    "fully_masked_row": (2, 2, 129, 129, None, "row", False, (64, 128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_CUDA_FLASH_EDGE_CASES))
def test_cuda_flash_attention_edge_cases(case, dtype):
    dev = _card()
    B, H, Lq, Lk, bshape, with_mask, causal, blocks = \
        _CUDA_FLASH_EDGE_CASES[case]
    q, k, v, bias, mask = _mha_inputs(13, B, H, Lq, Lk, 64, bshape,
                                      bool(with_mask))
    if with_mask == "diagonal":
        mask[0, :Lk // 2 + 1] = 0
    elif with_mask == "row":
        mask[1] = 0
    blk = {} if blocks is None else dict(block_q=blocks[0],
                                         block_k=blocks[1])
    _flash_on_card(dev, dtype, q, k, v, bias, mask, causal=causal,
                   scale=0.125, **blk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_largest_key_block(dtype):
    """One key block of the largest size the score block takes; one key
    more raises."""
    dev = _card()
    cols = _build.library().mpr_flash_attention_max_cols(64)
    assert cols >= 1024
    q, k, v, _, mask = _mha_inputs(14, 1, 2, 40, cols, 64, with_mask=True)
    _flash_on_card(dev, dtype, q, k, v, None, mask, scale=0.125,
                   block_k=cols)
    x = torch.zeros((1, 1, cols + 1, 64), dtype=DTYPES[dtype][1], device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        pattn.flash_attention(x, x, x, block_k=2 * cols)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_flash_attention_backward(causal):
    """On the card, fp32: the kernel forward with the recompute backward
    (``_FlashAttention``, what a pipeline stage trains through under
    "pallas") against autograd through the plain version: dq, dk, dv and
    the summed (1, H) bias gradient within 1e-4 of each one's largest."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(4, 4, 50, 64, generator=gen).to(dev)
               .requires_grad_() for _ in range(3))
    bias = torch.randn(1, 4, 50, 50, generator=gen).to(dev).requires_grad_()
    mask = torch.ones(4, 50, dtype=torch.int32, device=dev)
    mask[1, 30:] = 0
    g = torch.randn(4, 4, 50, 64, generator=gen).to(dev)
    before = _build.launch_counts()["flash_attention"]
    got = torch.autograd.grad(pattn.flash_attention(
        q, k, v, bias, mask, causal=causal, scale=0.125),
        (q, k, v, bias), g)
    assert _build.launch_counts()["flash_attention"] == before + 1
    want = torch.autograd.grad(pattn.flash_attention_reference(
        q, k, v, bias, mask, causal=causal, scale=0.125), (q, k, v, bias), g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
