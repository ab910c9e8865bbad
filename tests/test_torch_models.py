"""The PyTorch port's models against the JAX package, on the CPU.

One seeded JAX init is shared by both sides through
``bridge.params_from_jax``; inputs come from a numpy seed. Widths are 128
so that the JAX fused norms take their Pallas kernel path, and both towers
and the T5 encoder use ``attention_impl="row"`` (the JAX row-attention
kernel in interpret mode) unless a test names another path: ``"xla"``, or
``"pallas"`` against the JAX flash kernel in interpret mode. fp32
tolerances: towers 1e-5 absolute, T5 encoder hidden 1e-4 on the row path
and 1e-5 on the head-layout paths; greedy token ids identical, under each
``decode_attention_impl``.
"""

import dataclasses

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
from multimodalpromptretrieval_tpu.parallel import mesh as jmesh  # noqa: E402
from multimodalpromptretrieval_tpu.text import CLIPBPETokenizer  # noqa: E402
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import serve as pserve  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint as pckpt,
)
from multimodalpromptretrieval_tpu_torch.models import (  # noqa: E402
    clip as pclip,
    mprgen as pmprgen,
    t5 as pt5,
)

CLIP_CFG = dataclasses.replace(
    jclip.CLIPConfig.tiny(), embed_dim=64, vision_width=128,
    text_width=128, context_length=16, vocab_size=514,
    attention_impl="row")
T5_CFG = dataclasses.replace(
    jt5.T5Config.tiny(vocab_size=256), d_model=128, d_kv=32, d_ff=256,
    attention_impl="row")
JCFG = jmprgen.MPRGenConfig(t5=T5_CFG, clip=CLIP_CFG, max_source_length=64)


def _port_cfg(jcfg):
    return pmprgen.MPRGenConfig(
        t5=pt5.T5Config(**dataclasses.asdict(jcfg.t5)),
        clip=pclip.CLIPConfig(**dataclasses.asdict(jcfg.clip)),
        max_source_length=jcfg.max_source_length)


PCFG = _port_cfg(JCFG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jmprgen.init_mprgen(jax.random.PRNGKey(0), JCFG)
    return jparams, bridge.params_from_jax(jparams, PCFG)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


QUESTIONS = ["what shape is shown in the image?", "what color is the cross?",
             "is there a circle in the image?", "what organ is this?",
             "is this a ct scan?", "where is the lesion?",
             "how many kidneys are there?", "which plane is it?"]


def test_bridge_maps_layouts(params):
    jp, pp = params
    w = np.asarray(jp["t5"]["encoder"]["block"]["attn"]["k"])[1]  # (D, W)
    W = T5_CFG.inner_dim
    np.testing.assert_array_equal(
        _np(pp.t5.encoder.block[1].attn.qkv[W:2 * W]), w.T)
    np.testing.assert_array_equal(
        _np(pp.clip.visual.blocks[0].attn.qkv.weight),
        np.asarray(jp["clip"]["visual"]["blocks"]["attn"]["wqkv"])[0].T)
    assert PCFG.needs_projection  # 64-wide CLIP space -> 128-wide T5


def test_clip_image_tokens_match_jax(params):
    jp, pp = params
    images = np.random.default_rng(0).normal(
        size=(4, 3, 32, 32)).astype(np.float32)
    want = jclip.clip_image_tokens(jp["clip"], CLIP_CFG, jnp.asarray(images))
    got = pclip.clip_image_tokens(pp.clip, PCFG.clip, _t(images))
    assert got.shape == (4, CLIP_CFG.num_image_tokens, 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [8, 5])
def test_clip_encode_text_matches_jax(params, n):
    """B=8 runs the JAX grouped block-diagonal packing (G=8); the port's
    plain causal tower must agree at fp32."""
    jp, pp = params
    tok = CLIPBPETokenizer.build_toy(context_length=16)
    ids = pclip.truncate_text_ids(tok.tokenize(QUESTIONS[:n]))
    np.testing.assert_array_equal(ids, jclip.truncate_text_ids(
        tok.tokenize(QUESTIONS[:n])))
    want = jclip.clip_encode_text(jp["clip"], CLIP_CFG, jnp.asarray(ids))
    got = pclip.clip_encode_text(pp.clip, PCFG.clip, _t(ids))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def _encoder_inputs(seed, B=4, L=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, T5_CFG.d_model)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[1, 15:] = 0
    mask[3, 9:] = 0
    return x, mask


def test_t5_encode_matches_jax(params):
    jp, pp = params
    x, mask = _encoder_inputs(1)
    want = jt5.t5_encode(jp["t5"], T5_CFG, jnp.asarray(x), jnp.asarray(mask))
    got = pt5.t5_encode(pp.t5, PCFG.t5, _t(x), _t(mask))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("early_stop", [True, False])
def test_greedy_decode_ids_match_jax(params, early_stop):
    """Same encoder states into both decodes (the JAX default indicator
    formulation vs the port's row-cache reference): ids identical."""
    jp, pp = params
    x, mask = _encoder_inputs(2)
    enc = np.asarray(jt5.t5_encode(jp["t5"], T5_CFG, jnp.asarray(x),
                                   jnp.asarray(mask)))
    want = jt5.t5_greedy_decode(jp["t5"], T5_CFG, jnp.asarray(enc),
                                jnp.asarray(mask), max_new_tokens=8,
                                early_stop=early_stop)
    got = pt5.t5_greedy_decode(pp.t5, PCFG.t5, _t(enc), _t(mask),
                               max_new_tokens=8, early_stop=early_stop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


# the port's attention_impl -> the JAX name that runs the same function on
# the CPU (JAX "pallas" needs a TPU; "pallas_interpret" is its CPU form)
_HEAD_IMPLS = {"xla": "xla", "pallas": "pallas_interpret"}


@pytest.mark.parametrize("impl", sorted(_HEAD_IMPLS))
def test_t5_encode_head_paths_match_jax(params, impl):
    """The head-layout encoder (JAX ``encoder_block`` under the scan) with
    ``attention_xla`` or the flash kernel, against JAX under that name."""
    jp, pp = params
    x, mask = _encoder_inputs(1)
    jcfg = dataclasses.replace(T5_CFG, attention_impl=_HEAD_IMPLS[impl])
    pcfg = dataclasses.replace(PCFG.t5, attention_impl=impl)
    want = jt5.t5_encode(jp["t5"], jcfg, jnp.asarray(x), jnp.asarray(mask))
    got = pt5.t5_encode(pp.t5, pcfg, _t(x), _t(mask))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", sorted(_HEAD_IMPLS))
def test_clip_towers_head_paths_match_jax(params, impl):
    """Both towers' head-layout blocks under ``attention_impl``; the text
    tower runs ``text_attention_impl`` when set (here "xla" under a ViT on
    ``impl``)."""
    jp, pp = params
    jcfg = dataclasses.replace(CLIP_CFG, attention_impl=_HEAD_IMPLS[impl])
    pcfg = dataclasses.replace(PCFG.clip, attention_impl=impl)
    images = np.random.default_rng(0).normal(
        size=(4, 3, 32, 32)).astype(np.float32)
    want = jclip.clip_image_tokens(jp["clip"], jcfg, jnp.asarray(images))
    got = pclip.clip_image_tokens(pp.clip, pcfg, _t(images))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    ids = pclip.truncate_text_ids(
        CLIPBPETokenizer.build_toy(context_length=16).tokenize(QUESTIONS[:5]))
    for text_impl in ("", "xla"):
        jc = dataclasses.replace(jcfg, text_attention_impl=text_impl)
        pc = dataclasses.replace(pcfg, text_attention_impl=text_impl)
        want = jclip.clip_encode_text(jp["clip"], jc, jnp.asarray(ids))
        got = pclip.clip_encode_text(pp.clip, pc, _t(ids))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_unknown_attention_impl_raises(params):
    _, pp = params
    x, mask = _encoder_inputs(1)
    with pytest.raises(ValueError, match="attention impl"):
        pt5.t5_encode(pp.t5, dataclasses.replace(
            PCFG.t5, attention_impl="flash"), _t(x), _t(mask))
    with pytest.raises(ValueError, match="attention impl"):
        pclip.clip_image_tokens(pp.clip, dataclasses.replace(
            PCFG.clip, attention_impl="flash"), torch.zeros((1, 3, 32, 32)))
    with pytest.raises(ValueError, match="decode_attention_impl"):
        pt5.t5_greedy_decode(pp.t5, dataclasses.replace(
            PCFG.t5, decode_attention_impl="row"), _t(x), _t(mask))


@pytest.mark.parametrize("impl", ["indicator", "fused", "pallas", "xla"])
def test_greedy_decode_ids_match_jax_under_each_decode_impl(params, impl):
    """Every ``decode_attention_impl`` name, JAX (its Pallas kernels in
    interpret mode) against the port (K7 / K6 plain versions): ids
    identical at fp32."""
    jp, pp = params
    x, mask = _encoder_inputs(3)
    enc = np.asarray(jt5.t5_encode(jp["t5"], T5_CFG, jnp.asarray(x),
                                   jnp.asarray(mask)))
    jcfg = dataclasses.replace(T5_CFG, decode_attention_impl=impl)
    pcfg = dataclasses.replace(PCFG.t5, decode_attention_impl=impl)
    want = jt5.t5_greedy_decode(jp["t5"], jcfg, jnp.asarray(enc),
                                jnp.asarray(mask), max_new_tokens=6,
                                early_stop=False)
    got = pt5.t5_greedy_decode(pp.t5, pcfg, _t(enc), _t(mask),
                               max_new_tokens=6, early_stop=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_serve_step_matches_jax(params):
    """CLIP text -> top-k (k=3) -> vote + bucket -> splice -> encode ->
    decode, one chunk, against the JAX fused step (Pallas top-k in
    interpret mode)."""
    jp, pp = params
    rng = np.random.default_rng(3)
    B, N, W = 8, 40, 24
    tok = CLIPBPETokenizer.build_toy(context_length=16)
    q_len = rng.integers(4, 12, size=B).astype(np.int32)
    q_ids = np.zeros((B, W), np.int32)
    for b in range(B):
        q_ids[b, :q_len[b]] = rng.integers(3, 200, size=q_len[b])
    n_answers = 7
    hint_len = rng.integers(3, 9, size=n_answers * 6).astype(np.int32)
    hint_ids = rng.integers(3, 200, size=(n_answers * 6, 8)).astype(np.int32)
    arrays = {
        "q_ids": q_ids, "q_len": q_len,
        "clip_text_ids": pclip.truncate_text_ids(tok.tokenize(QUESTIONS)),
        "prefix": rng.normal(size=(B, 5, 128)).astype(np.float32),
        "img_emb": rng.normal(size=(B, 64)).astype(np.float32)}
    index = rng.normal(size=(N, 128)).astype(np.float32)
    index_sq = (index * index).sum(-1)
    aid = rng.integers(0, n_answers, size=N).astype(np.int32)
    tables = (index, index_sq, aid, hint_ids, hint_len)

    step = jmesh.make_fused_serve_step(
        JCFG, k=3, use_quantifier=True, eos_id=1, max_new_tokens=6,
        topk_impl="pallas_interpret")
    want = step(jp, {k: jnp.asarray(v) for k, v in arrays.items()},
                *map(jnp.asarray, tables))
    got = pserve.fused_serve_step(
        pp, PCFG, {k: _t(v) for k, v in arrays.items()}, *map(_t, tables),
        k=3, use_quantifier=True, eos_id=1, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_embed_prefix_step_matches_jax(params):
    jp, pp = params
    images = np.random.default_rng(4).normal(
        size=(4, 3, 32, 32)).astype(np.float32)
    jemb, jpref = jmesh.make_image_embed_prefix_step(JCFG)(
        jp, jnp.asarray(images))
    emb, pref = pserve.image_embed_prefix_step(pp, PCFG, _t(images))
    assert pref.shape == (4, 5, 128)
    np.testing.assert_allclose(_np(emb), _np(jemb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(pref), _np(jpref), atol=1e-5, rtol=0)


def test_npz_checkpoint_with_bf16_leaves_loads(params, tmp_path):
    """A JAX checkpoint with bf16 leaves (stored as uint16 bits under the
    ``__bf16__`` manifest) loads through the bridge with equal values."""
    jp, _ = params
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_checkpoint(path, bf)
    with np.load(path) as z:
        assert "__bf16__" in z.files
    model, _, _ = pckpt.load_checkpoint(path, PCFG)
    want = bridge.params_from_jax(bf, PCFG)
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 want.state_dict().items()):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    np.testing.assert_array_equal(
        _np(model.t5.shared),
        np.asarray(bf["t5"]["shared"].astype(jnp.float32)))
