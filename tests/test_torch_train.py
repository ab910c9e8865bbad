"""The PyTorch port's training path against the JAX package, on the CPU.

Same inputs (numpy, from a seed) go through the JAX function and its port.
The JAX Pallas kernels run as the JAX tests run them on the CPU (interpret
mode); the port's wrappers take their plain versions on CPU tensors.

  * K5 ``row_attention`` and K9 ``short_attention``: fp32 1e-5 absolute,
    bf16 one ulp of the output.
  * The autograd Functions around K1, K5, K2, K3 against ``jax.grad`` of the
    JAX functions (whose backward is the same recompute in plain XLA): fp32
    1e-5 absolute on unit-scale inputs; bf16 two ulps of the largest
    gradient (both sides round at the same points; the products are summed
    in different orders), four for the norms' ``dw`` / ``db``, which sum
    the rows in bf16.
  * ``t5_loss`` / ``loss_fn`` and every gradient at dropout 0: fp32 loss
    1e-5, gradients 1e-4 of each leaf's largest magnitude; under bf16
    compute the gradients that reach the fp32 masters within 6% of each
    leaf's largest magnitude (two bf16 backward passes through four layers
    that sum their products in different orders).
  * Three optimizer steps from identical parameters and moments: fp32
    parameters within 1e-5 (5e-5 with bf16 moments, whose rounding can flip),
    the frozen CLIP towers bit-identical.
  * ``ReduceLROnPlateau``, checkpoints in both directions, dropout.

Tests marked ``cuda`` compare the two new kernels and the Functions' backward
with their plain versions on the card and skip without one.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.models import (  # noqa: E402
    clip as jclip,
    mprgen as jmprgen,
    t5 as jt5,
)
from multimodalpromptretrieval_tpu.ops import (  # noqa: E402
    norm as jnorm,
    row_attention as jrow,
    short_attention as jshort,
)
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.train import (  # noqa: E402
    checkpoint as jckpt,
    optim as joptim,
)
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import (  # noqa: E402
    clip as pclip,
    mprgen as pmprgen,
    t5 as pt5,
)
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    _build,
    layers as players,
    norm as pnorm,
    row_attention as prow,
    short_attention as pshort,
)
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint as pckpt,
    optim as poptim,
    rng as prng,
    step as psteps,
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
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype="float32"):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


def _j(a, dtype="float32"):
    a = jnp.asarray(a)
    return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a


def _ulp_bf16(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _tol(dtype, ref, ulps=1):
    return ATOL if dtype == "float32" else ulps * _ulp_bf16(ref)


def _rows(seed, B, L, H, Dh, n=3):
    """n (B, L, H*Dh) unit-scale row tensors, an (H, L, L) bias, a (B, L)
    key mask with a few keys of two rows masked out, a cotangent."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, L, H * Dh)).astype(np.float32)
          for _ in range(n)]
    bias = rng.normal(size=(H, L, L)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, L - 3:] = 0
    mask[-1, L // 2:] = 0
    g = rng.normal(size=(B, L, H * Dh)).astype(np.float32)
    return xs, bias, mask, g


# ---------------------------------------------------------------------------
# K5 / K9 forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_row_attention_matches_jax_kernel(with_bias, with_mask, dtype):
    (q, k, v), bias, mask, _ = _rows(0, B=3, L=20, H=4, Dh=16)
    bias = bias if with_bias else None
    mask = mask if with_mask else None
    kw = dict(heads=4, scale=0.25)
    want = jrow.row_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        None if bias is None else _j(bias, dtype),
        None if mask is None else _j(mask), interpret=True, **kw)
    got = prow.row_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype),
        None if bias is None else _t(bias, dtype),
        None if mask is None else _t(mask), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 20, 64)
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, atol=_tol(dtype, ref), rtol=0)


def test_row_attention_reads_strided_q_k_v():
    """q, k and v with different batch and row strides (column slices of
    differently packed tensors) give the result of contiguous copies."""
    (q, k, v), bias, mask, _ = _rows(1, B=2, L=9, H=2, Dh=16)
    qk = _t(np.concatenate([q, k], axis=-1))
    vv = _t(np.concatenate([v, v, v], axis=-1))
    kw = dict(heads=2, scale=1.0)
    got = prow.row_attention(qk[..., :32], qk[..., 32:], vv[..., 32:64],
                             _t(bias), _t(mask), **kw)
    want = prow.row_attention(_t(q), _t(k), _t(v), _t(bias), _t(mask), **kw)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("L", [7, 16, 50, 128])
def test_short_attention_matches_jax_kernel(L, group, dtype):
    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(2, 4, L, 64)).astype(np.float32)
               for _ in range(3))
    want = jshort.short_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  scale=0.125, group=group, interpret=True)
    got = pshort.short_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                 scale=0.125, group=group)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 4, L, 64)
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, atol=_tol(dtype, ref), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [63, 64, 65, 82, 127])
def test_short_attention_plain_matches_jax_at_tile_edges(L, dtype):
    """The lengths around the kernel's one- and two-key-tile forms (64 and
    128 keys), through strided head views of packed rows as the kernel
    reads them."""
    rng = np.random.default_rng(100 + L)
    qkv = rng.normal(size=(2, L, 3, 3, 64)).astype(np.float32)
    q, k, v = (np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    want = jshort.short_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  scale=0.125, interpret=True)
    tq, tk, tv = (_t(qkv, dtype)[:, :, i].transpose(1, 2) for i in range(3))
    assert not tq.is_contiguous()
    got = pshort.short_attention(tq, tk, tv, scale=0.125)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 3, L, 64)
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, atol=_tol(dtype, ref), rtol=0)


def test_short_attention_refuses_other_shapes():
    x = torch.zeros((1, 2, 129, 64))
    with pytest.raises(ValueError, match="L=129"):
        pshort.short_attention(x, x, x, scale=1.0)
    x = torch.zeros((1, 2, 16, 32))
    with pytest.raises(ValueError, match="head dim 32"):
        pshort.short_attention(x, x, x, scale=1.0)
    with pytest.raises(ValueError, match="share shape"):
        pshort.short_attention(torch.zeros((1, 2, 16, 64)),
                               torch.zeros((1, 2, 8, 64)),
                               torch.zeros((1, 2, 16, 64)), scale=1.0)


def test_plain_versions_launch_nothing():
    (q, k, v), _, _, _ = _rows(2, B=1, L=8, H=1, Dh=64)
    _build.reset_launch_counts()
    prow.row_attention(_t(q), _t(k), _t(v), heads=1, scale=1.0)
    h = _t(q).reshape(1, 1, 8, 64)
    pshort.short_attention(h, h, h, scale=1.0)
    assert set(_build.launch_counts().values()) == {0}
    assert {"row_attention", "short_attention"} <= set(
        _build.launch_counts())


# ---------------------------------------------------------------------------
# The Functions' gradients against jax.grad
# ---------------------------------------------------------------------------


def _grads_close(got, want, dtype, what, ulps=2):
    for name, g, w in zip(what, got, want):
        if w is None:
            assert g is None, name
            continue
        ref = _np(w)
        assert tuple(g.shape) == ref.shape, name
        np.testing.assert_allclose(_np(g), ref, rtol=0, err_msg=name,
                                   atol=_tol(dtype, ref, ulps=ulps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_row_attention_packed_grads_match_jax(causal, with_bias, dtype):
    (q, k, v), bias, mask, g = _rows(3, B=3, L=12, H=4, Dh=16)
    qkv = np.concatenate([q * 0.25, k, v], axis=-1)
    kw = dict(heads=4, scale=1.0, causal=causal)
    jb = _j(bias, dtype) if with_bias else None

    def jloss(qkv, bias):
        out = jrow.row_attention_packed(qkv, bias, _j(mask), interpret=True,
                                        **kw)
        return jnp.sum(out.astype(jnp.float32) * _j(g))

    want = jax.grad(jloss, argnums=(0, 1) if with_bias else (0,))(
        _j(qkv, dtype), jb)
    tq = _t(qkv, dtype).requires_grad_()
    tb = _t(bias, dtype).requires_grad_() if with_bias else None
    out = prow.row_attention_packed(tq, tb, _t(mask), **kw)
    loss = torch.sum(out.float() * _t(g))
    got = torch.autograd.grad(loss, (tq, tb) if with_bias else (tq,))
    assert all(a.dtype == getattr(torch, dtype) for a in got)
    _grads_close(got, want, dtype, ("dqkv", "dbias"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_row_attention_grads_match_jax(with_bias, with_mask, dtype):
    (q, k, v), bias, mask, g = _rows(4, B=2, L=10, H=2, Dh=16)
    kw = dict(heads=2, scale=0.25)
    jm = _j(mask) if with_mask else None
    tm = _t(mask) if with_mask else None
    n = 4 if with_bias else 3

    def jloss(q, k, v, bias):
        out = jrow.row_attention(q, k, v, bias, jm, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * _j(g))

    want = jax.grad(jloss, argnums=tuple(range(n)))(
        _j(q, dtype), _j(k, dtype), _j(v, dtype),
        _j(bias, dtype) if with_bias else None)
    ts = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    tb = _t(bias, dtype).requires_grad_() if with_bias else None
    out = prow.row_attention(*ts, tb, tm, **kw)
    loss = torch.sum(out.float() * _t(g))
    got = torch.autograd.grad(loss, (*ts, tb)[:n])
    _grads_close(got, want, dtype, ("dq", "dk", "dv", "dbias"))


def test_row_attention_without_bias_has_no_bias_gradient():
    (q, k, v), _, mask, _ = _rows(5, B=2, L=6, H=2, Dh=8)
    import types

    ctx = types.SimpleNamespace(
        saved_tensors=(_t(q), _t(k), _t(v), None, _t(mask)),
        cfg=(False, 2, 1.0, False))
    grads = prow._RowAttention.backward(ctx, torch.ones((2, 6, 16)))
    # (packed, q, k, v, bias, kv_mask, heads, scale, causal)
    assert [x is None for x in grads] == [True, False, False, False, True,
                                          True, True, True, True]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
def test_fused_norm_grads_match_jax(rms, dtype):
    """Shapes that take the JAX Pallas kernel in the forward (W % 128 == 0,
    rows >= 16); its backward is ``jax.vjp`` of the plain norm."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 16, 128)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(128,)).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    assert jnorm._supported(jnp.asarray(x))
    vecs = (w,) if rms else (w, b)
    jfn = jnorm.fused_rms_norm if rms else jnorm.fused_layer_norm
    pfn = pnorm.fused_rms_norm if rms else pnorm.fused_layer_norm

    def jloss(x, *vecs):
        return jnp.sum(jfn(x, *vecs).astype(jnp.float32) * _j(g))

    want = jax.grad(jloss, argnums=tuple(range(1 + len(vecs))))(
        _j(x, dtype), *(_j(a, dtype) for a in vecs))
    ts = [_t(a, dtype).requires_grad_() for a in (x, *vecs)]
    loss = torch.sum(pfn(*ts).float() * _t(g))
    got = torch.autograd.grad(loss, ts)
    assert got[1].shape == (128,)  # dw reduced over the rows
    # dw / db sum 32 rounded rows, in bf16 in a different order: 4 ulps
    _grads_close(got, want, dtype, ("dx", "dw", "db"), ulps=4)


def test_fused_norm_function_skips_unneeded_gradients():
    x = torch.randn((4, 8), generator=torch.Generator().manual_seed(0))
    w = torch.ones(8, requires_grad=True)
    y = pnorm.fused_rms_norm(x, w)
    (dw,) = torch.autograd.grad(y.sum(), (w,))
    want = torch.autograd.grad(players.rms_norm(x, w).sum(), (w,))[0]
    np.testing.assert_allclose(_np(dw), _np(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def test_dropout_rate_determinism_and_eval_identity():
    x = torch.ones((400, 500))
    y = players.dropout(x, 0.1, prng.dropout_generator(7, "cpu"))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    # inverted dropout: survivors are scaled by 1 / (1 - rate)
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.9, rtol=1e-6)
    again = players.dropout(x, 0.1, prng.dropout_generator(7, "cpu"))
    assert torch.equal(y, again)
    other = players.dropout(x, 0.1, prng.dropout_generator(8, "cpu"))
    assert not torch.equal(y, other)
    assert players.dropout(x, 0.1, None) is x  # evaluation
    assert players.dropout(x, 0.0, prng.dropout_generator(7, "cpu")) is x


# ---------------------------------------------------------------------------
# The model: loss and gradients
# ---------------------------------------------------------------------------

CLIP_CFG = dataclasses.replace(
    jclip.CLIPConfig.tiny(), embed_dim=64, vision_width=128,
    text_width=128, context_length=16, vocab_size=514,
    attention_impl="row")
T5_CFG = dataclasses.replace(
    jt5.T5Config.tiny(vocab_size=256), d_model=128, d_kv=32, d_ff=256,
    attention_impl="row", dropout_rate=0.0)
JCFG = jmprgen.MPRGenConfig(t5=T5_CFG, clip=CLIP_CFG, max_source_length=64)


def _port_cfg(jcfg):
    return pmprgen.MPRGenConfig(
        t5=pt5.T5Config(**dataclasses.asdict(jcfg.t5)),
        clip=pclip.CLIPConfig(**dataclasses.asdict(jcfg.clip)),
        freeze=jcfg.freeze, compute_dtype=jcfg.compute_dtype,
        max_source_length=jcfg.max_source_length)


def _with(jcfg, t5=None, **kw):
    if t5:
        kw["t5"] = dataclasses.replace(jcfg.t5, **t5)
    return dataclasses.replace(jcfg, **kw)


@pytest.fixture(scope="module")
def jparams():
    return jmprgen.init_mprgen(jax.random.PRNGKey(0), JCFG)


def _batch(seed=0, B=4, Lt=12, T=6, images=False):
    """A train batch: prompt ids with padded tails, labels padded with
    -100, cached vision tokens (B, 5, 64) or raw images."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 256, size=(B, Lt)).astype(np.int32)
    mask = np.ones((B, Lt), np.int32)
    mask[1, 8:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    labels = rng.integers(2, 256, size=(B, T)).astype(np.int64)
    labels[0, 4:] = -100
    labels[2, 2:] = -100
    out = {"input_ids": ids, "text_mask": mask, "labels": labels}
    if images:
        out["images"] = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    else:
        out["vision_tokens"] = rng.normal(
            size=(B, 5, 64)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _pbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _leafwise_close(got, want, rel, what=""):
    """Each tensor of ``got`` (by the port's names) against ``want`` within
    ``rel`` of the leaf's largest magnitude."""
    assert set(got) == set(want)
    for name in want:
        ref = _np(want[name])
        np.testing.assert_allclose(
            _np(got[name]), ref, rtol=0,
            atol=rel * max(np.abs(ref).max(), 1e-3),
            err_msg=f"{what} {name}")


@pytest.mark.parametrize("impl", ["row", "xla"])
def test_t5_loss_and_gradients_match_jax(jparams, impl):
    """``t5_loss`` and its gradient for every T5 parameter and for the
    input embeddings, under the row path (K1 + K3 Functions) and the
    head-layout path."""
    jcfg = _with(JCFG, t5=dict(attention_impl=impl))
    pcfg = _port_cfg(jcfg)
    rng = np.random.default_rng(1)
    b = _batch(1)
    embeds = rng.normal(size=(4, 17, 128)).astype(np.float32)
    mask = np.concatenate([np.ones((4, 5), np.int32), b["text_mask"]], 1)
    labels = b["labels"]

    jloss, (gp, ge) = jax.value_and_grad(jt5.t5_loss, argnums=(0, 2))(
        jparams["t5"], jcfg.t5, jnp.asarray(embeds), jnp.asarray(mask),
        jnp.asarray(labels.astype(np.int32)))
    pp = bridge.params_from_jax(jparams, pcfg)
    te = _t(embeds).requires_grad_()
    loss = pt5.t5_loss(pp.t5, pcfg.t5, te, _t(mask), _t(labels))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    named = dict(pp.t5.named_parameters())
    grads = torch.autograd.grad(loss, [te, *named.values()])
    np.testing.assert_allclose(
        _np(grads[0]), _np(ge), rtol=0, atol=1e-4 * np.abs(_np(ge)).max())
    full = jax.tree.map(jnp.zeros_like, jparams)
    full["t5"] = gp
    want = {k[3:]: v for k, v in bridge.tensors_from_jax(full, pcfg).items()
            if k.startswith("t5.")}
    _leafwise_close(dict(zip(named, grads[1:])), want, 1e-4, impl)


@pytest.mark.parametrize("images", [False, True])
def test_loss_fn_gradients_reach_only_the_trainable_side(jparams, images):
    """``loss_fn`` from cached vision tokens and from raw images (the frozen
    tower under ``no_grad``): the loss and every gradient match JAX, the
    CLIP towers get none, the projection behind the tokens gets its own."""
    pcfg = _port_cfg(JCFG)
    b = _batch(2, images=images)
    jloss, jg = jax.value_and_grad(jmprgen.loss_fn)(jparams, JCFG,
                                                    _jbatch(b))
    pp = bridge.params_from_jax(jparams, pcfg)
    pmprgen.set_trainable(pp, pmprgen.trainable_mask(pp, pcfg))
    loss = pmprgen.loss_fn(pp, pcfg, _pbatch(b))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    got = psteps.backward(loss, pp)
    want = bridge.tensors_from_jax(jg, pcfg)
    assert not any(k.startswith("clip.") for k in got)
    for k, v in want.items():
        if k.startswith("clip."):  # stop_gradient on the JAX side
            assert not np.any(_np(v)), k
    assert "proj.weight" in got and "t5.shared" in got
    _leafwise_close(got, {k: want[k] for k in got}, 1e-4)


def test_trainable_mask_matches_jax(jparams):
    for freeze in (False, True):
        jcfg = _with(JCFG, freeze=freeze)
        pcfg = _port_cfg(jcfg)
        pp = bridge.params_from_jax(jparams, pcfg)
        got = pmprgen.trainable_mask(pp, pcfg)
        jmask = jax.tree.map(lambda m, p: jnp.full(p.shape, m),
                             jmprgen.trainable_mask(jparams, jcfg), jparams)
        want = bridge.tensors_from_jax(jmask, pcfg)
        assert set(got) == set(want)
        for name, on in got.items():
            assert bool(want[name].all()) == on == bool(want[name].any()), \
                name
        if freeze:
            assert [n for n, on in got.items() if on and n.startswith("t5")
                    ] == ["t5.shared"]


def test_bf16_compute_gradients_reach_fp32_masters(jparams):
    """Under bf16 compute the gradients are those of the bf16 copy (bf16
    tensors, ``t5.shared`` accumulated over its three uses in bf16), and the
    update applies them to the fp32 masters, as ``jax.grad`` through
    ``cast_compute`` does."""
    jcfg = _with(JCFG, compute_dtype="bfloat16")
    pcfg = _port_cfg(jcfg)
    b = _batch(3)
    jloss, jg = jax.value_and_grad(jmprgen.loss_fn)(jparams, jcfg,
                                                    _jbatch(b))
    assert jg["t5"]["shared"].dtype == jnp.float32
    pp = bridge.params_from_jax(jparams, pcfg)
    mask = pmprgen.trainable_mask(pp, pcfg)
    pmprgen.set_trainable(pp, mask)
    with pytest.raises(ValueError, match="compute copy"):
        pmprgen.loss_fn(pp, pcfg, _pbatch(b))
    run = pmprgen.cast_compute(pp, pcfg)
    assert run is not pp and run.t5.shared.dtype == torch.bfloat16
    loss = pmprgen.loss_fn(pp, pcfg, _pbatch(b), compute=run)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=0.05, rtol=0)
    got = psteps.backward(loss, run)
    assert all(g.dtype == torch.bfloat16 for g in got.values())
    want = bridge.tensors_from_jax(jg, pcfg)
    _leafwise_close(got, {k: want[k] for k in got}, 0.06, "bf16")
    before = pp.t5.shared.detach().clone()
    state = poptim.adamw_init(pp)
    poptim.adamw_update(pp, got, state, 1e-3, trainable=mask)
    assert pp.t5.shared.dtype == torch.float32
    assert state["mu"]["t5.shared"].dtype == torch.float32
    assert not torch.equal(pp.t5.shared, before)
    # the copy is refreshed from the moved masters at the next loss
    pmprgen.loss_fn(pp, pcfg, _pbatch(b), compute=run)
    assert torch.equal(run.t5.shared, pp.t5.shared.bfloat16())


@pytest.mark.parametrize("impl", ["row", "xla"])
def test_remat_recomputes_the_same_step(jparams, impl):
    """``cfg.remat`` is honoured (each layer under
    ``torch.utils.checkpoint``) and changes neither the loss nor a gradient,
    with dropout on: the recompute replays the layer's masks."""
    b = _pbatch(_batch(4))
    out = {}
    for remat in (False, True):
        pcfg = _port_cfg(_with(JCFG, t5=dict(
            attention_impl=impl, remat=remat, dropout_rate=0.1)))
        pp = bridge.params_from_jax(jparams, pcfg)
        pmprgen.set_trainable(pp, pmprgen.trainable_mask(pp, pcfg))
        _build.reset_launch_counts()
        loss = pmprgen.loss_fn(pp, pcfg, b, prng.dropout_generator(5, "cpu"))
        out[remat] = (loss.item(), psteps.backward(loss, pp))
    assert out[True][0] == out[False][0]
    for name, g in out[False][1].items():
        np.testing.assert_allclose(_np(out[True][1][name]), _np(g),
                                   atol=1e-6, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# The optimizer and the train step
# ---------------------------------------------------------------------------


def test_reduce_lr_on_plateau_matches_jax():
    rng = np.random.default_rng(0)
    metrics = [2.0, 1.5, 1.2] + [1.2 + 0.01 * i for i in range(12)] + \
        [1.0, 0.99995] + list(1.0 + rng.random(25))
    js, ps = joptim.ReduceLROnPlateau(lr=1e-3), \
        poptim.ReduceLROnPlateau(lr=1e-3)
    lrs = [(js.step(m), ps.step(m)) for m in metrics]
    assert [a for a, _ in lrs] == [b for _, b in lrs]
    assert len({a for a, _ in lrs}) >= 3  # the sequence did reduce it twice
    assert (js.best, js.num_bad_epochs) == (ps.best, ps.num_bad_epochs)


def _three_steps(jparams, jcfg, moments_dtype=None):
    """One JAX step makes non-zero moments; from there three steps of the
    JAX train step and of the port's, on three different batches. Returns
    the port's start and end parameters, the JAX end tree as the port's
    tensors, both loss lists and both end states."""
    pcfg = _port_cfg(jcfg)
    trainable = jmprgen.trainable_mask(jparams, jcfg)
    jstep = jmesh.make_train_step(jcfg, trainable, donate=False)
    jstate = joptim.adamw_init(jparams, moments_dtype=moments_dtype)
    jp, jstate, _ = jstep(jparams, jstate, _jbatch(_batch(10)),
                          jnp.float32(1e-3), None)

    pp = bridge.params_from_jax(jp, pcfg)
    start = {n: p.detach().clone() for n, p in pp.named_parameters()}
    pstate = bridge.opt_state_from_jax(jstate, pcfg)
    pstep = psteps.make_train_step(pcfg, pmprgen.trainable_mask(pp, pcfg))
    jlosses, plosses = [], []
    for i in range(3):
        b = _batch(11 + i)
        jp, jstate, jl = jstep(jp, jstate, _jbatch(b), jnp.float32(1e-3),
                               None)
        pl = pstep(pp, pstate, _pbatch(b), 1e-3)
        assert not pl.requires_grad
        jlosses.append(float(jl))
        plosses.append(pl.item())
    end = dict(pp.named_parameters())
    return (start, end, bridge.tensors_from_jax(jp, pcfg), jlosses, plosses,
            jstate, pstate, pcfg)


def test_three_train_steps_match_jax(jparams):
    start, end, want, jl, pl, jstate, pstate, pcfg = _three_steps(
        jparams, JCFG)
    np.testing.assert_allclose(pl, jl, atol=1e-5, rtol=0)
    assert pstate["step"] == int(jstate["step"]) == 4
    moved = 0
    for name, ref in want.items():
        if name.startswith("clip."):
            assert torch.equal(end[name], start[name]), name
            np.testing.assert_array_equal(_np(end[name]), _np(ref))
        else:
            np.testing.assert_allclose(_np(end[name]), _np(ref), atol=1e-5,
                                       rtol=0, err_msg=name)
            moved += not torch.equal(end[name], start[name])
    assert moved == sum(not n.startswith("clip.") for n in want)
    for kind in ("mu", "nu"):
        jm = bridge.tensors_from_jax(jstate[kind], pcfg)
        for name, ref in jm.items():
            np.testing.assert_allclose(_np(pstate[kind][name]), _np(ref),
                                       atol=1e-6, rtol=0, err_msg=name)


def test_freeze_moves_only_the_shared_embedding(jparams):
    start, end, want, jl, pl, _, pstate, _ = _three_steps(
        jparams, _with(JCFG, freeze=True))
    np.testing.assert_allclose(pl, jl, atol=1e-5, rtol=0)
    moved = [n for n in end if not torch.equal(end[n], start[n])]
    # of T5 only the embedding; the projection outside T5 trains on, as in
    # the JAX mask (t5-small has none)
    assert moved == ["t5.shared", "proj.weight", "proj.bias"]
    for name in end:
        np.testing.assert_allclose(_np(end[name]), _np(want[name]),
                                   atol=1e-5, rtol=0, err_msg=name)
    assert not pstate["mu"]["t5.encoder.final_ln"].any()


def test_bf16_moments_are_stored_rounded(jparams):
    start, end, want, jl, pl, jstate, pstate, pcfg = _three_steps(
        jparams, JCFG, moments_dtype="bfloat16")
    assert all(m.dtype == torch.bfloat16 for m in pstate["mu"].values())
    assert all(v.dtype == torch.bfloat16 for v in pstate["nu"].values())
    assert jstate["mu"]["t5"]["shared"].dtype == jnp.bfloat16
    np.testing.assert_allclose(pl, jl, atol=1e-5, rtol=0)
    for name, ref in want.items():
        np.testing.assert_allclose(_np(end[name]), _np(ref), atol=5e-5,
                                   rtol=0, err_msg=name)


def test_adamw_is_the_jax_formula_not_torch_optims():
    """One leaf, many steps: bit-equal moments and parameters within fp32
    rounding of the JAX update; frozen leaves and their moments untouched."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 7)).astype(np.float32)
    model = torch.nn.Module()
    model.a = torch.nn.Parameter(_t(w0))
    model.b = torch.nn.Parameter(_t(w0))
    jp = {"a": jnp.asarray(w0), "b": jnp.asarray(w0)}
    jstate = joptim.adamw_init(jp)
    pstate = poptim.adamw_init(model)
    mask = {"a": True, "b": False}
    for i in range(20):
        g = rng.normal(size=(5, 7)).astype(np.float32)
        jp, jstate = joptim.adamw_update(
            jp, {"a": jnp.asarray(g), "b": jnp.asarray(g)}, jstate,
            jnp.float32(3e-3), trainable=mask)
        poptim.adamw_update(model, {"a": _t(g), "b": _t(g)}, pstate, 3e-3,
                            trainable=mask)
    np.testing.assert_allclose(_np(model.a), _np(jp["a"]), atol=2e-7, rtol=0)
    np.testing.assert_allclose(_np(pstate["nu"]["a"]), _np(jstate["nu"]["a"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_np(model.b), w0)
    assert not pstate["mu"]["b"].any() and pstate["step"] == 20


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------


def _trained_pair(jparams, moments_dtype):
    """Parameters and non-zero AdamW state after two JAX steps, in both
    packages' layouts."""
    trainable = jmprgen.trainable_mask(jparams, JCFG)
    jstep = jmesh.make_train_step(JCFG, trainable, donate=False)
    jstate = joptim.adamw_init(jparams, moments_dtype=moments_dtype)
    jp = jparams
    for i in range(2):
        jp, jstate, _ = jstep(jp, jstate, _jbatch(_batch(20 + i)),
                              jnp.float32(1e-3), None)
    return jp, jstate


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
def test_jax_checkpoint_loads_in_the_port(jparams, tmp_path, moments_dtype):
    pcfg = _port_cfg(JCFG)
    jp, jstate = _trained_pair(jparams, moments_dtype)
    path = str(tmp_path / "jax.npz")
    meta = {"epoch": 3, "valid_loss": 1.25, "lr": 5e-4, "config": {"k": 1}}
    jckpt.save_checkpoint(path, jp, jstate, metadata=meta)
    with np.load(path) as z:
        assert ("__bf16__" in z.files) == (moments_dtype == "bfloat16")
        assert json.loads(str(z["__elided_opt__"]))  # the frozen towers
    template = poptim.adamw_init(bridge.params_from_jax(jparams, pcfg),
                                 moments_dtype)
    pp, pstate, got_meta = pckpt.load_checkpoint(path, pcfg, template)
    assert got_meta == meta and pstate["step"] == 2
    b = _batch(30)
    want = float(jmprgen.loss_fn(jp, JCFG, _jbatch(b)))
    got = pmprgen.loss_fn(pp, pcfg, _pbatch(b)).item()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for kind in ("mu", "nu"):
        ref = bridge.tensors_from_jax(jstate[kind], pcfg)
        for name, t in pstate[kind].items():
            assert t.dtype == template[kind][name].dtype
            np.testing.assert_array_equal(_np(t), _np(ref[name]),
                                          err_msg=name)
    # without a template the optimizer state is not asked for
    assert pckpt.load_checkpoint(path, pcfg)[1] is None


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
def test_port_checkpoint_loads_in_jax(jparams, tmp_path, moments_dtype):
    pcfg = _port_cfg(JCFG)
    jp, jstate = _trained_pair(jparams, moments_dtype)
    pp = bridge.params_from_jax(jp, pcfg)
    pstate = bridge.opt_state_from_jax(jstate, pcfg)
    path = str(tmp_path / "models" / "port.npz")
    meta = {"epoch": 1, "valid_loss": 0.5, "lr": 1e-3, "config": {"k": 3}}
    pckpt.save_checkpoint(path, pp, pcfg, pstate, metadata=meta)
    template = joptim.adamw_init(jparams, moments_dtype=moments_dtype)
    lp, lstate, got_meta = jckpt.load_checkpoint(path, jparams, template)
    assert got_meta == meta and int(lstate["step"]) == 2
    for got, want in zip(jax.tree.leaves(lp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for kind in ("mu", "nu"):
        for got, want in zip(jax.tree.leaves(lstate[kind]),
                             jax.tree.leaves(jstate[kind])):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(_np(got), _np(want))
    b = _batch(31)
    want = pmprgen.loss_fn(pp, pcfg, _pbatch(b)).item()
    np.testing.assert_allclose(float(jmprgen.loss_fn(lp, JCFG, _jbatch(b))),
                               want, atol=1e-5, rtol=0)
    # and back into the port: the file is its own round trip
    rp, rstate, _ = pckpt.load_checkpoint(path, pcfg,
                                          poptim.adamw_init(pp,
                                                            moments_dtype))
    for (n, a), (_, c) in zip(rp.named_parameters(), pp.named_parameters()):
        assert torch.equal(a, c), n
    assert rstate["step"] == 2
    for n, t in pstate["nu"].items():
        assert torch.equal(rstate["nu"][n], t), n


def test_checkpoint_of_another_model_is_refused(jparams, tmp_path):
    path = str(tmp_path / "small.npz")
    jckpt.save_checkpoint(path, {"t5": jparams["t5"]})
    with pytest.raises(ValueError, match="does not match the model"):
        pckpt.load_checkpoint(path, _port_cfg(JCFG))


def test_bridge_round_trips_parameters_and_state(jparams):
    pcfg = _port_cfg(JCFG)
    pp = bridge.params_from_jax(jparams, pcfg)
    back = bridge.tree_numpy(bridge.params_to_jax(pp, pcfg))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (path, a), (_, c) in zip(flat_b, flat_j):
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=str(path))
    state = poptim.adamw_init(pp, "bfloat16")
    state["step"] = 7
    tree = bridge.tree_numpy(bridge.opt_state_to_jax(state, pcfg))
    assert tree["mu"]["t5"]["shared"].dtype.name == "bfloat16"
    again = bridge.opt_state_from_jax(tree, pcfg)
    assert again["step"] == 7 and set(again["mu"]) == set(state["mu"])


# ---------------------------------------------------------------------------
# On the card: the two new kernels and the Functions' backward
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("L", [5, 70])
def test_cuda_row_attention_qkv_kernel(dtype, with_bias, L):
    dev = _card()
    (q, k, v), bias, mask, _ = _rows(8, B=3, L=L, H=4, Dh=64)
    args = [_t(x, dtype).to(dev) for x in (q, k, v)]
    args += [_t(bias, dtype).to(dev), _t(mask).to(dev)] if with_bias \
        else [None, None]
    before = _build.launch_counts()["row_attention"]
    got = prow.row_attention(*args, heads=4, scale=0.5)
    want = prow.row_attention_reference(*args, heads=4, scale=0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts()["row_attention"] == before + 1
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 7, 50, 128])
def test_cuda_short_attention_kernel(dtype, L):
    dev = _card()
    rng = np.random.default_rng(L)
    qkv = _t(rng.normal(size=(3, L, 3, 4, 64)).astype(np.float32),
             dtype).to(dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # views
    before = _build.launch_counts()["short_attention"]
    got = pshort.short_attention(q, k, v, scale=0.125)
    want = pshort.short_attention_reference(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts()["short_attention"] == before + 1
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)
    with pytest.raises(NotImplementedError, match="forward-only"):
        pshort.short_attention(q.clone().requires_grad_(), k, v, scale=1.0)


def _short_inputs(L, layout, dtype, dev, B=3, H=5, scale_q=1.0):
    """q, k, v (B, H, L, 64) on the card. B * H = 15 is no multiple of the
    2 or 4 heads a block of the short shapes packs. ``views``: head views of
    packed (B, L, 3, H, 64) rows; ``contiguous``: three (B, H, L, 64)
    tensors; ``unaligned``: the views, of a buffer that starts one element
    past a 16-byte boundary (the kernel's 2-byte / 4-byte load path)."""
    rng = np.random.default_rng(1000 + L)
    qkv = rng.normal(size=(B, L, 3, H, 64)).astype(np.float32)
    qkv[:, :, 0] *= scale_q
    flat = _t(qkv, dtype).reshape(-1)
    if layout == "unaligned":
        buf = torch.zeros(flat.numel() + 1, dtype=flat.dtype, device=dev)
        buf[1:] = flat.to(dev)
        packed = buf[1:].view(B, L, 3, H, 64)
        assert packed.data_ptr() % 16 != 0
    else:
        packed = flat.to(dev).view(B, L, 3, H, 64)
    q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _short_on_card(q, k, v, scale, dtype):
    before = _build.launch_counts()["short_attention"]
    got = pshort.short_attention(q, k, v, scale=scale)
    want = pshort.short_attention_reference(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert _build.launch_counts()["short_attention"] == before + 1
    assert got.is_contiguous() and got.shape == q.shape
    ref = _np(want)
    tol = 2e-5 if dtype == "float32" else _ulp_bf16(ref)
    np.testing.assert_allclose(_np(got), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["views", "contiguous", "unaligned"])
@pytest.mark.parametrize("L", [1, 7, 15, 16, 17, 50, 63, 64, 65, 82, 127,
                               128])
def test_cuda_short_attention_tile_edges(L, layout, dtype):
    """Around every form of the kernel: 16, 32, 64 and 128 keys a warp, the
    fp32 kernel's 32 query rows and 64 keys."""
    dev = _card()
    q, k, v = _short_inputs(L, layout, dtype, dev)
    _short_on_card(q, k, v, 0.125, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [16, 50, 82, 128])
def test_cuda_short_attention_large_scores(L, dtype):
    """scale=1.0 on unit-variance rows: scores of some +-30, softmax close
    to one-hot, where a fast exp or a reciprocal would show first."""
    dev = _card()
    q, k, v = _short_inputs(L, "views", dtype, dev)
    _short_on_card(q, k, v, 1.0, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_short_attention_one_head_and_many(dtype):
    """B * H = 1 (one head in a block made for four) and a grid of many
    blocks with a ragged last one."""
    dev = _card()
    for B, H, L in ((1, 1, 16), (1, 1, 30), (37, 3, 9), (21, 7, 20)):
        q, k, v = _short_inputs(L, "views", dtype, dev, B=B, H=H)
        _short_on_card(q, k, v, 0.125, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_row_attention_backward(dtype, causal):
    """Kernel forward + the recompute backward on the card against autograd
    through the plain version: fp32 1e-4 of the largest gradient, bf16 four
    ulps of it (the recompute rounds where autograd keeps fp32)."""
    dev = _card()
    (q, k, v), bias, mask, g = _rows(9, B=3, L=40, H=4, Dh=64)
    qkv = _t(np.concatenate([q * 0.125, k, v], -1), dtype).to(dev)
    qkv.requires_grad_()
    tb = _t(bias, dtype).to(dev).requires_grad_()
    tm, tg = _t(mask).to(dev), _t(g, dtype).to(dev)
    kw = dict(heads=4, scale=1.0, causal=causal)
    got = torch.autograd.grad(
        prow.row_attention_packed(qkv, tb, tm, **kw), (qkv, tb), tg)
    want = torch.autograd.grad(
        prow.row_attention_packed_reference(qkv, tb, tm, **kw), (qkv, tb),
        tg)
    for a, w in zip(got, want):
        ref = _np(w)
        tol = (1e-4 * np.abs(ref).max() if dtype == "float32"
               else 4 * _ulp_bf16(ref))
        np.testing.assert_allclose(_np(a), ref, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
def test_cuda_fused_norm_backward(dtype, rms):
    dev = _card()
    rng = np.random.default_rng(10)
    x = _t((rng.normal(size=(64, 512)) * 2 + 0.5).astype(np.float32),
           dtype).to(dev).requires_grad_()
    vecs = [_t(rng.normal(size=(512,)).astype(np.float32),
               dtype).to(dev).requires_grad_()
            for _ in range(1 if rms else 2)]
    g = _t(rng.normal(size=(64, 512)).astype(np.float32), dtype).to(dev)
    name = "fused_rms_norm" if rms else "fused_layer_norm"
    got = torch.autograd.grad(getattr(pnorm, name)(x, *vecs), (x, *vecs), g)
    want = torch.autograd.grad(getattr(pnorm, name + "_reference")(
        x, *vecs), (x, *vecs), g)
    for a, w in zip(got, want):
        ref = _np(w)
        tol = (1e-4 * np.abs(ref).max() if dtype == "float32"
               else 4 * _ulp_bf16(ref))
        np.testing.assert_allclose(_np(a), ref, atol=tol, rtol=0)
