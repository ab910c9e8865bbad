"""The port's hint-draft speculative decode against the JAX package, on the
CPU.

``block_attention_indicator`` of both packages on the same numpy inputs
(fp32 within 1e-5, bf16 within one bf16 ulp). ``t5_spec_greedy_decode`` on
one seeded JAX init bridged into the port, over the same encoder states:
greedy ids identical to the JAX spec decode and to the port's lockstep
decode for random, perfect, partial and short drafts, blocks 1 / 2 / 4, a
block wider than the budget, under ``decode_attention_impl`` "indicator"
and "xla"; the pass count is capped by the budget and falls to
ceil(T / (S + 1)) with perfect drafts. ``MPRServer(spec_decode=4)`` gives
the lockstep server's answers, with the JAX package's draft table. On the card (``cuda`` marker): the spec
decode against lockstep at fp32.
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
from multimodalpromptretrieval_tpu.ops import (  # noqa: E402
    decode_attention as jdecode,
)
from multimodalpromptretrieval_tpu.retrieval import hints as jhints  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import (  # noqa: E402
    clip as pclip,
    mprgen as pmprgen,
    t5 as pt5,
)
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    decode_attention as pdecode,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
    synthetic_config,
    synthetic_slake,
)

JCFG = jmprgen.MPRGenConfig(t5=jt5.T5Config.tiny(vocab_size=97),
                            clip=jclip.CLIPConfig.tiny())
PCFG = pmprgen.MPRGenConfig(
    t5=pt5.T5Config(**dataclasses.asdict(JCFG.t5)),
    clip=pclip.CLIPConfig(**dataclasses.asdict(JCFG.clip)))
T = 12


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


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["self", "cross"])
def test_block_attention_indicator_matches_jax(case, dtype):
    """Self-attention: (B, S, H, T) bias with per-row validity folded in;
    cross-attention: a (B, T) key mask."""
    rng = np.random.default_rng(0)
    B, S, H, Dh, L = 4, 5, 4, 32, 24
    W = H * Dh
    q = rng.normal(size=(B, S, W)).astype(np.float32)
    k, v = (rng.normal(size=(B, L, W)).astype(np.float32) for _ in range(2))
    bias = mask = None
    if case == "self":
        bias = rng.normal(size=(B, S, H, L)).astype(np.float32)
        bias[:, :, :, L - 3:] = -1e9  # slots past the frontier
    else:
        mask = rng.integers(0, 2, size=(B, L)).astype(np.int32)
        mask[:, 0] = 1
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _np(jdecode.block_attention_indicator(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), heads=H,
        bias=None if bias is None else jnp.asarray(bias),
        kv_mask=None if mask is None else jnp.asarray(mask)))
    got = pdecode.block_attention_indicator(
        *(_t(x).to(tdt) for x in (q, k, v)), heads=H, bias=_t(bias),
        kv_mask=_t(mask))
    assert got.dtype == tdt and got.shape == (B, S, W)
    tol = (1e-5 if dtype == "float32"
           else 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def setup():
    """One JAX init on both sides, encoder states from the JAX encoder, and
    the JAX lockstep ids of T steps (equal to the port's: the lockstep
    decode's own parity tests)."""
    jp = jmprgen.init_mprgen(jax.random.PRNGKey(7), JCFG)
    pp = bridge.params_from_jax(jp, PCFG).t5
    rng = np.random.default_rng(3)
    B, L = 5, 9
    embeds = rng.normal(size=(B, L, JCFG.t5.d_model)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, -2:] = 0
    mask[3, -4:] = 0
    enc = np.asarray(jt5.t5_encode(jp["t5"], JCFG.t5, jnp.asarray(embeds),
                                   jnp.asarray(mask)))
    ref = np.asarray(jt5.t5_greedy_decode(
        jp["t5"], JCFG.t5, jnp.asarray(enc), jnp.asarray(mask),
        max_new_tokens=T))
    return jp["t5"], pp, enc, mask, ref


def _draft(kind, ref, B):
    rng = np.random.default_rng(11)
    perfect = np.array(ref[:, 1:], np.int32)  # the continuation, EOS, pad
    if kind == "random":
        return rng.integers(2, 97, size=(B, 10)).astype(np.int32)
    if kind == "perfect":
        return perfect
    if kind == "short":
        return perfect[:, :3].copy()
    partial = perfect.copy()
    partial[0, 2:] = 55  # diverges after 2 tokens
    partial[2, :] = 7  # useless
    partial[4, 0] = 3  # diverges at once
    return partial


@pytest.mark.parametrize("kind, block, steps, impl", [
    ("random", 1, T, "indicator"),
    ("random", 2, T, "indicator"),
    ("random", 4, T, "indicator"),
    ("perfect", 4, T, "indicator"),
    ("partial", 4, T, "indicator"),
    ("short", 4, T, "indicator"),
    ("perfect", 8, 3, "indicator"),  # a block wider than the budget
    ("partial", 4, T, "xla"),
    ("random", 2, T, "xla"),
])
def test_spec_decode_ids_match_jax_and_lockstep(setup, kind, block, steps,
                                                impl):
    jt5p, pp, enc, mask, ref = setup
    draft = _draft(kind, ref, enc.shape[0])
    jcfg = dataclasses.replace(JCFG.t5, decode_attention_impl=impl)
    pcfg = dataclasses.replace(PCFG.t5, decode_attention_impl=impl)
    want = np.asarray(jt5.t5_spec_greedy_decode(
        jt5p, jcfg, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(draft),
        max_new_tokens=steps, block=block))
    got = pt5.t5_spec_greedy_decode(pp, pcfg, _t(enc), _t(mask), _t(draft),
                                    max_new_tokens=steps, block=block)
    lockstep = pt5.t5_greedy_decode(pp, pcfg, _t(enc), _t(mask),
                                    max_new_tokens=steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), lockstep.numpy())


def test_pass_count_is_capped(setup):
    """Perfect drafts accept S + 1 tokens a pass: at most ceil(T / (S + 1))
    passes; useless drafts still accept one, so never more than T."""
    _, pp, enc, mask, ref = setup
    counts = {}
    for kind, block in (("perfect", 3), ("random", 3), ("perfect", 1)):
        stats = {}
        got = pt5.t5_spec_greedy_decode(
            pp, PCFG.t5, _t(enc), _t(mask), _t(_draft(kind, ref, 5)),
            max_new_tokens=T, block=block, stats=stats)
        np.testing.assert_array_equal(got.numpy(), ref)
        counts[kind, block] = stats["passes"]
    assert 1 <= counts["perfect", 3] <= -(-T // 4)
    assert 1 <= counts["perfect", 1] <= -(-T // 2)
    assert counts["perfect", 3] <= counts["random", 3] <= T
    with pytest.raises(ValueError, match="block"):
        pt5.t5_spec_greedy_decode(pp, PCFG.t5, _t(enc), _t(mask),
                                  _t(ref[:, 1:]), block=0)


def test_spec_decode_server_gives_lockstep_answers():
    """``MPRServer(spec_decode=4)`` on the fused path drafts with each
    row's vote winner: the lockstep server's answers, chunk by chunk."""
    splits, images = synthetic_slake(12, 4, image_size=32, seed=2)
    cfg = synthetic_config(batch_size=4, retrieval=True, k=3, image_size=32)
    cfg["clip_overrides"]["patch_size"] = 16
    # about the corpus tokenizer's ids, so that generated ids decode to text
    cfg["t5_overrides"]["vocab_size"] = 128
    exp = ServingExperiment(cfg, train=splits["train"], test=splits["test"],
                            images=images, device="cpu")
    with torch.no_grad():  # a zero pad embedding: the answers carry text
        exp.params.t5.shared[0] = 0.0
    entries = splits["test"]
    names = [e["image_name"] for e in entries]
    ask = (np.stack([images[n] for n in names]),
           [e["question"] for e in entries], [e["task"] for e in entries])
    want = MPRServer(exp, load_checkpoint=False).answer(*ask, image_ids=names)
    server = MPRServer(exp, load_checkpoint=False, spec_decode=4)
    got = server.answer(*ask, image_ids=names)
    assert got == want and any(a for a in got)
    assert server.chunks == {"fused": 3, "host": 0}
    # the draft table: the JAX package's rows for the same answers
    tables = jhints.build_draft_tables(exp.retrieval_index, exp.tokenizer)
    np.testing.assert_array_equal(server._draft_tables.ids.numpy(),
                                  np.asarray(tables.ids))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "perfect", "partial"])
def test_cuda_spec_decode_matches_lockstep(kind):
    """On the card at fp32, head dim 64 (K7 in the lockstep steps, the
    plain block attention in the passes): identical ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = pt5.T5Config(vocab_size=97, d_model=128, d_kv=64, d_ff=256,
                       num_layers=2, num_decoder_layers=2, num_heads=2)
    params = pt5.T5(cfg, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(5)
    enc = _t(rng.normal(size=(6, 9, 128)).astype(np.float32)).to(dev)
    mask = torch.ones((6, 9), dtype=torch.int32, device=dev)
    mask[1, 5:] = 0
    lockstep = pt5.t5_greedy_decode(params, cfg, enc, mask, max_new_tokens=T)
    draft = lockstep[:, 1:].clone()
    if kind == "random":
        draft = _t(rng.integers(2, 97, size=(6, 10)).astype(np.int32))
    elif kind == "partial":
        draft[::2, 3:] = 5
    got = pt5.t5_spec_greedy_decode(params, cfg, enc, mask, draft.to(dev),
                                    max_new_tokens=T, block=4)
    assert torch.equal(got, lockstep)
