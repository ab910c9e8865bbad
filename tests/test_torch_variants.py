"""The port's text-only, prediction-head and BAN variants against the JAX
package, on the CPU.

Per module (fp32, max abs error <= 1e-5): ``weight_norm_kernel``, FCNet,
``bcnet_logits``, ``bcnet_forward_with_weights``, ``biattention_apply``
(an all-zero image row, ``q_valid``) and ``biresnet_apply``, with the JAX
weights bridged in. Per variant (fp32, dropout off): logits and losses
within 1e-5 with -100 rows, identical class ids, the gradients of a train
step within 1e-4 of their largest magnitude, identical greedy ids, BAN's
bucket-width invariance; the dropout sites and their rates, reproduced by
the port's generator. The slice: the JAX and port servers give the same
answer strings for the 9-row request at B=4 (chunks of consecutive rows),
BAN ignores the index, each variant trains one epoch and is tested with a
checkpoint that crosses to the JAX package and back, the ROCO generator's
copy writes the JAX module's rows and CSVs, the ROCO index extends the
retrieval index, the checkpoint keys and ``vision_encoder`` are accepted
as the JAX package accepts them, and ``--eval --qid`` runs.
"""

import copy
import filecmp
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.data import roco_questions as jroco  # noqa: E402
from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.models import ban as jban  # noqa: E402
from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.models.clip import CLIPConfig as JCLIP  # noqa: E402
from multimodalpromptretrieval_tpu.models.t5 import T5Config as JT5  # noqa: E402
from multimodalpromptretrieval_tpu.ops.layers import (  # noqa: E402
    weight_norm_kernel as j_weight_norm,
)
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import cli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.data import roco_questions as proco  # noqa: E402
from multimodalpromptretrieval_tpu_torch.data.datasets import load_dataset  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import ban as pban  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.clip import (  # noqa: E402
    CLIPConfig as PCLIP,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config as PT5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import layers  # noqa: E402
from multimodalpromptretrieval_tpu_torch.retrieval.index import (  # noqa: E402
    RetrievalIndex,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
    build_roco_index,
    synthetic_roco,
)
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint as pckpt,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
    run_from_config,
)

TOL = 1e-5
# the variants' config keys
VARIANTS = {
    "text": dict(use_image_info=0),
    "head": dict(use_prediction_head=1),
    "ban": dict(use_prediction_head=1, use_BAN=1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Modules and variant functions on a tiny model
# ---------------------------------------------------------------------------

_T5 = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=1,
           num_decoder_layers=1, num_heads=2)
_CLIP = dict(embed_dim=16, image_resolution=32, vision_layers=1,
             vision_width=16, patch_size=16, context_length=16,
             vocab_size=64, text_width=16, vision_heads_override=2,
             text_heads_override=2)


def _model(zero_pad=False, glimpse=2, **kw):
    """(JAX params, JAX config, port params, port config) of one tiny
    model, the JAX init bridged into the port. ``zero_pad``: a random tied
    head re-emits its input token and the decode starts from pad, so a
    zero pad row makes greedy ids that mean something (BAN normalises the
    prompt rows: a zero row there is NaN). Two BAN glimpses keep JAX's
    compile short; the experiments below run the reference's ten."""
    jcfg = jmprgen.MPRGenConfig(t5=JT5(**_T5), clip=JCLIP(**_CLIP),
                                num_classes=5, glimpse=glimpse, **kw)
    pcfg = pmprgen.MPRGenConfig(t5=PT5(**_T5), clip=PCLIP(**_CLIP),
                                num_classes=5, glimpse=glimpse, **kw)
    jp = jmprgen.init_mprgen(jax.random.PRNGKey(0), jcfg)
    if zero_pad:
        jp["t5"]["shared"] = jp["t5"]["shared"].at[0].set(0.0)
    return jp, jcfg, bridge.params_from_jax(jp, pcfg), pcfg


_MODELS = {"head": dict(use_prediction_head=True),
           "ban": dict(use_prediction_head=True, use_ban=True),
           "text": dict(use_image_info=False, zero_pad=True)}


@pytest.fixture(scope="module")
def models():
    """kind -> (kind, JAX params, JAX config, port params, port config),
    each built once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = (kind,) + _model(**_MODELS[kind])
        return cache[kind]
    return get


@pytest.fixture(params=list(_MODELS))
def model(models, request):
    return models(request.param)


@pytest.fixture
def ban_model(models):
    return models("ban")[1:]


def _inputs(lens=(5, 9, 7), width=12, seed=7):
    """images, ids, mask (numpy) of a batch whose rows have ``lens``
    tokens, padded to ``width``."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    images = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    ids = np.zeros((B, width), np.int32)
    mask = np.zeros((B, width), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, 60, size=n)
        mask[i, :n] = 1
    return images, ids, mask


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.max(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)))
    assert err <= tol, f"max abs error {err:.3g} > {tol}"


def _ban_case(name, jp, pp):
    """(port output, JAX output) of one BAN module on seeded inputs."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(3, 4, 16)).astype(np.float32)
    v[1, 2] = 0.0  # an all-zero image row: no attention reaches it
    q = rng.normal(size=(3, 6, 16)).astype(np.float32)
    w = rng.random(size=(3, 4, 6)).astype(np.float32)
    q_valid = np.arange(6)[None, :] < np.asarray([[4], [6], [5]])
    jv, jq, jw, jqv = map(jnp.asarray, (v, q, w, q_valid))
    tv, tq, tw, tqv = map(torch.from_numpy, (v, q, w, q_valid))
    jatt, patt = jp["ban"]["att"], pp.ban.att
    jres, pres = jp["ban"]["res"], pp.ban.res
    if name == "weight_norm_kernel":
        jl = jatt["logits"]["v_net"][0]
        return (layers.weight_norm_kernel(patt.logits.v_net[0].v,
                                          patt.logits.v_net[0].g).t(),
                j_weight_norm(jl["v"], jl["g"]))
    if name == "fcnet":
        return (pban.fcnet_apply(pres.q_prj[0], tq, act=""),
                jban.fcnet_apply(jres["q_prj"][0], jq, act=""))
    if name == "fcnet_relu":
        return (pban.fcnet_apply(patt.logits.q_net, tq),
                jban.fcnet_apply(jatt["logits"]["q_net"], jq))
    if name == "bcnet_logits":
        return (pban.bcnet_logits(patt.logits, tv, tq),
                jban.bcnet_logits(jatt["logits"], jv, jq, k=3))
    if name == "bcnet_forward_with_weights":
        return (pban.bcnet_forward_with_weights(pres.b_net[0], tv, tq, tw),
                jban.bcnet_forward_with_weights(jres["b_net"][0], jv, jq, jw,
                                                k=1))
    if name == "biattention":
        got = pban.biattention_apply(patt, tv, tq, q_valid=tqv)[0]
        want = jban.biattention_apply(jatt, jv, jq, q_valid=jqv)[0]
        assert float(got[1, :, 2].abs().max()) == 0.0
        assert float(got[0, :, :, 4:].abs().max()) == 0.0
        _close(got.sum((2, 3)), np.ones((3, 2)), 1e-5)
        return got, want
    if name == "biresnet":
        att = np.asarray(jban.biattention_apply(jatt, jv, jq,
                                                q_valid=jqv)[0])
        return (pban.biresnet_apply(pres, tv, tq, torch.from_numpy(att),
                                    q_valid=tqv),
                jban.biresnet_apply(jres, jv, jq, jnp.asarray(att),
                                    q_valid=jqv))
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "weight_norm_kernel", "fcnet", "fcnet_relu", "bcnet_logits",
    "bcnet_forward_with_weights", "biattention", "biresnet"])
def test_ban_module_matches_jax(ban_model, name):
    jp, _, pp, _ = ban_model
    with torch.no_grad():
        got, want = _ban_case(name, jp, pp)
    assert got.shape == tuple(np.shape(want))
    _close(got, want)


def test_weight_norm_kernel_bf16_casts_back():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    g = torch.tensor(2.5)
    w = layers.weight_norm_kernel(v.bfloat16(), g.bfloat16())
    assert w.dtype == torch.bfloat16
    want = j_weight_norm(jnp.asarray(v.numpy()).astype(jnp.bfloat16),
                         jnp.asarray(2.5, jnp.bfloat16))
    assert np.array_equal(w.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def _batches(kind, lens=(5, 9, 7), width=12):
    images, ids, mask = _inputs(lens, width)
    batch = dict(images=images, input_ids=ids, text_mask=mask)
    if kind == "text":
        del batch["images"]
        labels = np.full((len(lens), 4), -100, np.int32)
        labels[:, :3] = [[5, 6, 1], [7, 1, 0], [9, 9, 1]]
        labels[1, 2:] = -100
        batch["labels"] = labels
    else:
        batch["class_labels"] = np.asarray([1, -100, 3][:len(lens)],
                                           np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("kind", ["head", "ban"])
def test_variant_logits_and_class_ids_match_jax(models, kind):
    kind, jp, jcfg, pp, pcfg = models(kind)
    jb, pb = _batches(kind)
    jfn, pfn = ((jmprgen.ban_logits, pmprgen.ban_logits) if kind == "ban"
                else (jmprgen.head_logits, pmprgen.head_logits))
    args = ("images", "input_ids", "text_mask")
    with torch.no_grad():
        got = pfn(pp, pcfg, *(pb[a] for a in args))
    want = jax.jit(lambda p, *a: jfn(p, jcfg, *a))(
        jp, *(jb[a] for a in args))
    _close(got, want)
    ids = pmprgen.predict_fn(pp, pcfg, pb)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.jit(
        lambda p, b: jmprgen.predict_fn(p, jcfg, b))(jp, jb)))
    np.testing.assert_array_equal(ids.numpy(), np.argmax(np.asarray(want), -1))


def test_variant_loss_matches_jax(model):
    """With a -100 row (a batch's fill row): out of the sum and the
    divisor in both packages."""
    kind, jp, jcfg, pp, pcfg = model
    jb, pb = _batches(kind)
    with torch.no_grad():
        got = pmprgen.loss_fn(pp, pcfg, pb)
    _close(got, jax.jit(lambda p, b: jmprgen.loss_fn(p, jcfg, b))(jp, jb))


def test_variant_gradients_match_jax(model):
    """The gradients of one train step: every trainable parameter within
    1e-4 of its largest magnitude (CLIP is frozen in both)."""
    kind, jp, jcfg, pp, pcfg = model
    jb, pb = _batches(kind)
    jgrads = bridge.tensors_from_jax(jax.jit(jax.grad(
        lambda p, b: jmprgen.loss_fn(p, jcfg, b)))(jp, jb), pcfg)
    run = copy.deepcopy(pp)
    mask = pmprgen.trainable_mask(run, pcfg)
    pmprgen.set_trainable(run, mask)
    loss = pmprgen.loss_fn(run, pcfg, pb)
    names = [n for n, on in mask.items() if on]
    params = dict(run.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    assert any(n.startswith(("head.", "ban.")) for n in names) == (
        kind != "text")
    for name, g in zip(names, grads):
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if g is None else g.numpy()
        if name == "ban.att.logits.h_bias":
            # a per-glimpse shift of the logits, which the softmax over the
            # glimpse cancels: zero up to rounding in both
            assert max(np.abs(g).max(), np.abs(want).max()) < 1e-6
            continue
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g - want).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3g} > 1e-4 x {scale:.3g}"


def test_ban_train_steps_match_jax(models):
    """Three AdamW steps of the BAN variant at fp32 without dropout: the
    losses along the way and the parameters after them agree with the JAX
    package's (loss -> grad -> ``adamw_update`` in each)."""
    from multimodalpromptretrieval_tpu.train import optim as joptim
    from multimodalpromptretrieval_tpu_torch.train import optim as poptim
    from multimodalpromptretrieval_tpu_torch.train.step import backward

    _, jp, jcfg, pp, pcfg = models("ban")
    jb, pb = _batches("ban")
    jmask = jmprgen.trainable_mask(jp, jcfg)
    jopt = joptim.adamw_init(jp)
    step = jax.jit(jax.value_and_grad(
        lambda p, b: jmprgen.loss_fn(p, jcfg, b)))
    update = jax.jit(lambda p, g, o: joptim.adamw_update(
        p, g, o, 1e-3, trainable=jmask))
    pp = copy.deepcopy(pp)
    pmask = pmprgen.trainable_mask(pp, pcfg)
    pmprgen.set_trainable(pp, pmask)
    popt = poptim.adamw_init(pp)
    for _ in range(3):
        jl, g = step(jp, jb)
        jp, jopt = update(jp, g, jopt)
        pl = pmprgen.loss_fn(pp, pcfg, pb)
        poptim.adamw_update(pp, backward(pl, pp), popt, 1e-3,
                            trainable=pmask)
        _close(pl, jl)
    want = bridge.tensors_from_jax(jp, pcfg)
    for name, p in pp.named_parameters():
        if name == "ban.att.logits.h_bias":
            # its gradient is zero up to rounding (see the gradient test),
            # so AdamW steps it by about lr in the rounding's direction
            _close(p, want[name].numpy(), 2 * 3 * 1e-3)
            continue
        assert float((p - want[name]).abs().max()) <= 1e-4, name


def test_text_only_greedy_ids_match_jax(models):
    kind, jp, jcfg, pp, pcfg = models("text")
    jb, pb = _batches(kind)
    got = pmprgen.predict_fn(pp, pcfg, pb, max_new_tokens=6)
    want = jax.jit(lambda p, b: jmprgen.predict_fn(
        p, jcfg, b, max_new_tokens=6))(jp, jb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1:] != 0).any()


def test_ban_logits_bucket_width_invariant(ban_model):
    """Padding past the batch's longest prompt changes nothing: the extra
    question columns are masked out of the softmax and the final sum."""
    _, _, pp, pcfg = ban_model
    outs = []
    for width in (9, 16, 32):
        images, ids, mask = map(torch.from_numpy,
                                _inputs((5, 9, 7), width))
        with torch.no_grad():
            outs.append(pmprgen.ban_logits(pp, pcfg, images, ids, mask))
    for o in outs[1:]:
        _close(o, outs[0].numpy())
        assert torch.equal(o.argmax(-1), outs[0].argmax(-1))


def test_ban_zero_prompt_row_is_nan_in_both(ban_model):
    """The L2 normalisation has no epsilon: a zero embedding row (here the
    pad row, zeroed) is NaN in both packages, in the same rows."""
    jp, jcfg, _, pcfg = ban_model
    jp = dict(jp, t5=dict(jp["t5"], shared=jp["t5"]["shared"].at[0].set(0)))
    pp = bridge.params_from_jax(jp, pcfg)
    images, ids, mask = _inputs((5, 9, 7))
    with torch.no_grad():
        got = pmprgen.ban_logits(pp, pcfg, *map(torch.from_numpy,
                                               (images, ids, mask)))
    want = np.asarray(jax.jit(lambda p, *a: jmprgen.ban_logits(p, jcfg, *a))(
        jp, *map(jnp.asarray, (images, ids, mask))))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


def test_head_reads_the_chunks_longest_prompt(models):
    """The head's position is the longest prompt's last token over the
    batch (quirk #10): a row's logits change with its batch mates."""
    kind, _, _, pp, pcfg = models("head")
    images, ids, mask = map(torch.from_numpy, _inputs((5, 9, 7)))
    with torch.no_grad():
        whole = pmprgen.head_logits(pp, pcfg, images, ids, mask)
        alone = pmprgen.head_logits(pp, pcfg, images[:1], ids[:1], mask[:1])
    assert not torch.allclose(whole[:1], alone, atol=1e-4)


def test_dropout_sites_rates_and_reproducibility(monkeypatch, ban_model,
                                                 models):
    """Each dropout site of the head variants runs at the JAX package's
    rate (BAN: 0.2 in the attention FCNets, 0.5 on v, 0.2 in the pooling
    FCNets and the question projection, 0.1 on the fused vector; the head:
    0.1 on the pooled state), drops about that share, and a seeded
    generator reproduces the result."""
    _, _, pp, pcfg = ban_model
    _, _, _, hp, hcfg = models("head")
    calls = []
    real = layers.dropout

    def recorded(x, rate, gen):
        y = real(x, rate, gen)
        if gen is not None and rate > 0:
            calls.append((rate, int((y == 0).sum() - (x == 0).sum()),
                          int((x != 0).sum())))
        return y

    monkeypatch.setattr(pban, "dropout", recorded)
    monkeypatch.setattr(pmprgen, "dropout", recorded)
    images, ids, mask = map(torch.from_numpy, _inputs((5, 9, 7)))
    with torch.no_grad():
        plain = pmprgen.ban_logits(pp, pcfg, images, ids, mask)
        assert calls == []
        outs = [pmprgen.ban_logits(pp, pcfg, images, ids, mask,
                                   gen=torch.Generator().manual_seed(3))
                for _ in range(2)]
        g = pcfg.glimpse
        rates = [c[0] for c in calls[:len(calls) // 2]]
        assert rates == [0.2, 0.2, 0.5] + [0.2, 0.2, 0.2] * g + [0.1]
        head_calls = len(calls)
        pmprgen.head_logits(hp, hcfg, images, ids, mask,
                            gen=torch.Generator().manual_seed(3))
        assert [c[0] for c in calls[head_calls:]] == [0.1]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], plain)
    for rate in (0.2, 0.5):
        dropped = sum(c[1] for c in calls if c[0] == rate)
        total = sum(c[2] for c in calls if c[0] == rate)
        assert abs(dropped / total - rate) < 0.03, (rate, dropped / total)


# ---------------------------------------------------------------------------
# The slice: experiments, servers, training, checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_variants"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=16,
                             n_validate=8, n_test=8, image_size=32, seed=0)
    return root


def _config(root, variant, retrieval=True):
    cfg = synthetic_config(root, batch_size=4, epochs=1, image_size=32,
                           retrieval=retrieval, k=1)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    # the vocabulary of the corpus-built tokenizer (117 ids), so that every
    # generated id decodes to text
    cfg["t5_overrides"].update(vocab_size=117, attention_impl="row")
    cfg["cache_retrieval"] = False
    cfg.update(VARIANTS[variant])
    return cfg


def _splits(exp):
    return dict(train=exp.splits["train"], validate=exp.splits["validate"],
                test=exp.splits["test"], images=exp.images)


def _pair(data_root, kind):
    """(variant, JAX Experiment, port ServingExperiment): one config, the
    JAX weights bridged in (text-only: the pad row zeroed, so that the
    answers carry text; BAN would normalise it to NaN)."""
    cfg = _config(data_root, kind)
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True,
                      log_root=os.path.join(data_root, "logs"),
                      model_root=os.path.join(data_root, "models"))
    if kind == "text":
        shared = jexp.params["t5"]["shared"]
        jexp.params["t5"]["shared"] = shared.at[0].set(0.0)
    splits = dict(train=jexp.dataset_train.entries,
                  validate=jexp.dataset_validate.entries,
                  test=jexp.dataset_test.entries, images=jexp.images)
    probe = ServingExperiment(dict(cfg, retrieval=0), device="cpu", **splits)
    assert probe.model_cfg.num_classes == jexp.model_cfg.num_classes
    params = bridge.params_from_jax(jexp.params, probe.model_cfg)
    return kind, jexp, ServingExperiment(cfg, params=params, device="cpu",
                                         **splits)


@pytest.fixture(scope="module")
def pairs(data_root):
    """kind -> :func:`_pair`, each built once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _pair(data_root, kind)
        return cache[kind]
    return get


@pytest.fixture(params=list(VARIANTS))
def pair(pairs, request):
    return pairs(request.param)


def _requests(jexp):
    entries = (jexp.dataset_test.entries * 2)[:9]
    images = np.stack([jexp.images[e["image_name"]] for e in entries])
    return (images, [e["question"] for e in entries],
            [e["task"] for e in entries])


def test_server_answers_match_jax(pair):
    """The 9-row request at B=4: three chunks of consecutive rows, as the
    JAX server makes them; the answer strings are identical."""
    kind, jexp, pexp = pair
    images, questions, tasks = _requests(jexp)
    want = JServer(jexp, load_checkpoint=False).answer(images, questions,
                                                        tasks)
    server = MPRServer(pexp, load_checkpoint=False)
    got = server.answer(images, questions, tasks)
    assert got == want
    assert server.chunks == {"fused": 0, "host": 3}
    if kind == "text":
        assert server.decode_steps > 0 and any(got)
    else:
        assert server.decode_steps == 0
        assert set(got) <= set(pexp.label2ans.values())


def test_server_pipelined_submits_match_answer(pair):
    """The per-batch path through the dispatcher thread, two submits
    queued (depth 2): the one-shot answers, in order."""
    _, jexp, pexp = pair
    images, questions, tasks = _requests(jexp)
    server = MPRServer(pexp, load_checkpoint=False, pipeline_depth=2)
    h1 = server.submit(images, questions, tasks)
    h2 = server.submit(images[:5], questions[:5], tasks[:5])
    assert h2.result() == MPRServer(pexp, load_checkpoint=False).answer(
        images[:5], questions[:5], tasks[:5])
    assert h1.done() and len(h1.result()) == 9


def test_ban_answers_ignore_the_index(pairs):
    """BAN's prompts never carry the retrieval hint (quirk #9): serving
    with the index present answers as serving without it."""
    kind, jexp, pexp = pairs("ban")
    images, questions, tasks = _requests(jexp)
    with_index = MPRServer(pexp, load_checkpoint=False).answer(
        images, questions, tasks)
    exp = ServingExperiment(dict(pexp.cfg, retrieval=0), params=pexp.params,
                            device="cpu", **_splits(pexp))
    assert exp.retrieval_index is None
    assert MPRServer(exp, load_checkpoint=False).answer(
        images, questions, tasks) == with_index


def test_train_test_and_checkpoint_cross_to_jax(pair, tmp_path):
    """One epoch through ``TrainingExperiment.train`` (the head variants'
    train accuracy logged), ``test()`` from the saved checkpoint, the
    checkpoint (params and AdamW state) loaded by the JAX package, and a
    JAX checkpoint loaded by the port."""
    kind, jexp, pexp = pair
    cfg = copy.deepcopy(pexp.cfg)
    texp = TrainingExperiment(cfg, params=copy.deepcopy(pexp.params),
                              device="cpu", quiet=True,
                              log_root=str(tmp_path / "logs"),
                              model_root=str(tmp_path / "models"),
                              **_splits(pexp))
    lines = []
    texp.log = lines.append
    res = texp.train()
    assert res["parameter_updates"] == 12 and np.isfinite(
        res["best_valid_loss"])
    assert any(x.startswith("Train acc is: ") for x in lines) == (
        kind != "text")
    built = texp._vision_tokens is not None
    assert built == (kind != "text")
    metrics = texp.test()
    assert sum(metrics.total.values()) == len(pexp.splits["test"])
    assert 0.0 <= metrics.overall <= 1.0
    # the retrieval diagnostics are the generative variants' only
    assert bool(metrics.consistencies) == (kind == "text")

    params, opt, meta = jckpt.load_checkpoint(texp.model_path, jexp.params,
                                              _jax_adamw(jexp.params))
    assert meta["epoch"] == 0 and int(opt["step"]) == 12
    back = bridge.tensors_from_jax(params, texp.model_cfg)
    for name, p in texp.params.named_parameters():
        np.testing.assert_array_equal(back[name].numpy(),
                                      p.detach().numpy(), err_msg=name)
    mu = bridge.tensors_from_jax(opt["mu"], texp.model_cfg)
    for name, m in texp.opt_state["mu"].items():
        np.testing.assert_array_equal(mu[name].numpy(), m.numpy(),
                                      err_msg=name)

    path = str(tmp_path / "from_jax.npz")
    jckpt.save_checkpoint(path, jexp.params)
    loaded, _, _ = pckpt.load_checkpoint(path, texp.model_cfg)
    want = bridge.tensors_from_jax(jexp.params, texp.model_cfg)
    for name, p in loaded.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(),
                                      err_msg=name)


def _jax_adamw(params):
    from multimodalpromptretrieval_tpu.train.optim import adamw_init

    return adamw_init(params)


def test_cli_trains_tests_and_serves_each_variant(data_root, tmp_path,
                                                  monkeypatch, capsys):
    """``cli --train --test --serve`` on a config of each variant, from
    the dataset on disk."""
    monkeypatch.chdir(tmp_path)
    requests = tmp_path / "requests.jsonl"
    requests.write_text("\n".join(json.dumps(
        {"question": q, "task": "open", "image_name": n}) for q, n in (
            ("what shape is shown in the image?", "synthetic_00030.png"),
            ("what color is the circle?", "synthetic_00031.png"))) + "\n")
    for kind in VARIANTS:
        cfg = _config(data_root, kind)
        path = tmp_path / f"{kind}.json"
        path.write_text(json.dumps(cfg))
        cli.main(["--train", "--test", "--serve", "--config", str(path),
                  "--requests", str(requests), "--device", "cpu"])
        out = capsys.readouterr().out.strip().splitlines()
        answers = [json.loads(x) for x in out[-2:]]
        assert all(set(a) == {"answer"} for a in answers), (kind, out[-2:])


def test_run_from_config_accepts_the_variants(data_root, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    for kind in VARIANTS:
        path = tmp_path / f"{kind}.json"
        path.write_text(json.dumps(_config(data_root, kind, False)))
        exp, _ = run_from_config(str(path), device="cpu", quiet=True)
        assert exp.model_cfg.use_image_info == (kind != "text")
        assert exp.model_cfg.use_ban == (kind == "ban")


def _seeded(exp, jexp):
    """The port's and the JAX package's parameters equal their seeded
    inits (JAX: the key the Experiment splits off its seed)."""
    want = pmprgen.init_mprgen(exp.model_cfg, exp.cfg.get("seed", 88))
    for name, p in want.named_parameters():
        assert torch.equal(dict(exp.params.named_parameters())[name], p), name
    jwant = jmprgen.init_mprgen(jax.random.split(jax.random.PRNGKey(
        jexp.cfg.get("seed", 88)))[1], jexp.model_cfg)
    for a, b in zip(jax.tree.leaves(jexp.params), jax.tree.leaves(jwant)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _write_checkpoint(key, value, jcfg, root):
    """The file of ``key`` at ``value`` under ``root``, written by the
    port's exporters (torch files) or ``save_mapping`` from a JAX init of
    another seed; returns the top-level parts the file fills."""
    import dataclasses as dc

    from multimodalpromptretrieval_tpu_torch.models import export as pexport
    from tests.test_torch_resnet import _openai_sd

    if key == "vision_encoder":
        rn_sd, _ = _openai_sd(layers=(1, 1, 1, 1), width=8)
        torch.save({k: torch.from_numpy(v) for k, v in rn_sd.items()},
                   os.path.join(root, "rn.pt"))
        return ("clip_rn",)
    if key == "mapping_checkpoint":
        jcfg = dc.replace(jcfg, use_mapping=True)
    src = jax.tree.map(np.asarray,
                       jmprgen.init_mprgen(jax.random.PRNGKey(7), jcfg))
    path = os.path.join(root, value)
    if key == "mapping_checkpoint":
        pckpt.save_mapping(path, bridge.mapping_from_jax(src["mapping"]))
        return ("mapping",)
    if key == "t5_checkpoint":
        sd, parts = pexport.t5_to_hf(src["t5"], jcfg.t5), ("t5",)
    elif key == "reference_checkpoint":
        sd = pexport.mprgen_to_reference_state_dict(src, jcfg)
        parts = ("t5", "clip", "head")
    else:
        sd, parts = pexport.clip_to_openai(src["clip"], jcfg.clip), ("clip",)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if key == "vision_checkpoint":  # PubMedCLIP's layout
        sd = {"state_dict": {f"visual_encoder.{k}": v for k, v in sd.items()}}
    elif key == "reference_checkpoint":
        sd = {"model_state_dict": sd}
    torch.save(sd, path)
    return parts


@pytest.mark.parametrize("key,value", [
    ("vision_encoder", "RN50x4"), ("mapping_checkpoint", "m.pt"),
    ("reference_checkpoint", "r.pt"), ("t5_checkpoint", "t.pt"),
    ("vision_checkpoint", "v.pt"), ("clip_checkpoint", "c.pt")])
def test_unported_keys_still_raise(data_root, key, value, tmp_path,
                                   monkeypatch):
    """Each of these keys was refused before the pretrained-weights slice;
    now each is accepted as the JAX package accepts it. A path that does not
    exist leaves the seeded init in both packages (``mapping_checkpoint``
    still turns the mapping on); a file the exporters wrote gives both
    packages the same parameters. ``vision_encoder: RN50x4`` (tiny
    ``resnet_overrides``) loads an OpenAI-layout ResNet through
    ``vision_checkpoint``."""
    monkeypatch.chdir(tmp_path)
    cfg = _config(data_root, "head", False)
    cfg[key] = value
    if key == "vision_encoder":
        cfg["resnet_overrides"] = dict(layers=[1, 1, 1, 1], width=8,
                                       embed_dim=24, heads=4)
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True)
    for cls in (ServingExperiment, TrainingExperiment):
        exp = cls(copy.deepcopy(cfg), device="cpu")
        _seeded(exp, jexp)
        assert exp.model_cfg.use_mapping == (key == "mapping_checkpoint")
        assert (exp.model_cfg.resnet is not None) == (
            key == "vision_encoder")
    parts = _write_checkpoint(key, value, jexp.model_cfg, str(tmp_path))
    if key == "vision_encoder":
        cfg["vision_checkpoint"] = "rn.pt"
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True)
    for cls in (ServingExperiment, TrainingExperiment):
        exp = cls(copy.deepcopy(cfg), device="cpu")
        assert exp.model_prefix == jexp.model_prefix  # _resnet, _with_mapping
        got = bridge.tree_numpy(bridge.params_to_jax(exp.params,
                                                     exp.model_cfg))
        seeded = bridge.tree_numpy(bridge.params_to_jax(
            pmprgen.init_mprgen(exp.model_cfg, cfg["seed"]), exp.model_cfg))
        for part in parts:
            want = jax.tree.leaves(jexp.params[part])
            assert len(jax.tree.leaves(got[part])) == len(want), part
            for a, b in zip(jax.tree.leaves(got[part]), want):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=part)
        for part in set(got) - set(parts):  # the rest: the seeded init
            for a, b in zip(jax.tree.leaves(got[part]),
                            jax.tree.leaves(seeded[part])):
                np.testing.assert_array_equal(a, b, err_msg=part)


def test_shipped_config_checkpoint_keys_leave_the_seeded_init(
        data_root, tmp_path, monkeypatch):
    """``config/experiment.json`` names ``./assets/t5-small.bin`` and
    ``./assets/ViT-B-32.pt``, which the repository does not ship: with its
    keys over the tiny config, ``ServingExperiment``,
    ``TrainingExperiment`` and ``run_from_config`` skip the absent files
    and keep the seeded init, as the JAX package does."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "config", "experiment.json")) as f:
        shipped = json.load(f)
    monkeypatch.chdir(tmp_path)
    cfg = _config(data_root, "text", False)
    keys = ("t5_checkpoint", "clip_checkpoint", "vision_checkpoint",
            "vision_encoder", "spiece_model", "clip_bpe")
    cfg.update({k: shipped[k] for k in keys})
    assert shipped["t5_checkpoint"] and shipped["clip_checkpoint"]
    assert not os.path.exists(shipped["t5_checkpoint"])
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True)
    path = tmp_path / "shipped.json"
    path.write_text(json.dumps(cfg))
    exps = [ServingExperiment(copy.deepcopy(cfg), device="cpu"),
            TrainingExperiment(copy.deepcopy(cfg), device="cpu"),
            run_from_config(str(path), device="cpu", quiet=True)[0]]
    for exp in exps:
        _seeded(exp, jexp)
        assert exp.model_cfg.resnet is None and not exp.model_cfg.use_mapping


def test_checkpoint_placed_at_a_cached_path_rebuilds_the_index(
        data_root, tmp_path, monkeypatch):
    """An index embedded while ``clip_checkpoint``'s file was absent is
    cached under the seeded init; once the file is written at that same
    path, the index is embedded anew from the loaded CLIP (the cache key
    names the path, not what the file holds), and is never cached."""
    from multimodalpromptretrieval_tpu_torch.models import export as pexport

    monkeypatch.chdir(tmp_path)
    cfg = _config(data_root, "head", True)
    cfg.update(clip_checkpoint="c.pt", cache_retrieval=True,
               retrieval_cache_dir=str(tmp_path / "cache"))
    seeded = ServingExperiment(copy.deepcopy(cfg), device="cpu")
    assert seeded.loaded_files == []
    assert len(list((tmp_path / "cache").iterdir())) == 1
    cached = ServingExperiment(copy.deepcopy(cfg), device="cpu")
    torch.testing.assert_close(cached.retrieval_index.embeddings,
                               seeded.retrieval_index.embeddings,
                               rtol=0, atol=0)
    other = pmprgen.init_mprgen(seeded.model_cfg, 7)
    tree = bridge.tree_numpy(bridge.params_to_jax(other, seeded.model_cfg))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                pexport.clip_to_openai(tree["clip"],
                                       seeded.model_cfg.clip).items()},
               tmp_path / "c.pt")
    loaded = ServingExperiment(copy.deepcopy(cfg), device="cpu")
    assert loaded.loaded_files == ["c.pt"]
    fresh = ServingExperiment(dict(cfg, cache_retrieval=False), device="cpu")
    torch.testing.assert_close(loaded.retrieval_index.embeddings,
                               fresh.retrieval_index.embeddings,
                               rtol=0, atol=0)
    assert not torch.equal(loaded.retrieval_index.embeddings,
                           seeded.retrieval_index.embeddings)
    assert len(list((tmp_path / "cache").iterdir())) == 1


def test_unported_flag_and_mapping_still_raise(data_root, tmp_path,
                                               monkeypatch):
    """Both were refused before: ``--eval --qid`` now writes the text-only
    variant's attention figures (one per decoder layer and head), and
    ``use_mapping`` builds the mapping MLP."""
    monkeypatch.chdir(tmp_path)
    text = _config(data_root, "text", False)
    path = tmp_path / "text.json"
    path.write_text(json.dumps(text))
    qid = load_dataset(data_root, "SLAKE", "test").entries[0]["question_id"]
    cli.main(["--eval", "--qid", qid, "--config", str(path), "--device",
              "cpu"])
    t5 = text["t5_overrides"]
    heads = sorted(os.listdir(tmp_path / "figures" / qid))
    assert heads == sorted(f"head{j}" for j in range(t5["num_heads"]))
    assert all(sorted(os.listdir(tmp_path / "figures" / qid / h)) == [
        f"attention{i}.pdf" for i in range(t5["num_decoder_layers"])]
        for h in heads)
    cfg = pmprgen.MPRGenConfig(t5=PT5(**_T5), clip=PCLIP(**_CLIP),
                               use_mapping=True)
    model = pmprgen.init_mprgen(cfg, 0)
    assert tuple(model.mapping.fc1.weight.shape) == (16, 16)
    assert float(model.mapping.logit_scale.detach()) == pytest.approx(2.6592)
    assert pmprgen.trainable_mask(model, cfg)["mapping.fc2.bias"]


# ---------------------------------------------------------------------------
# The ROCO corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faithful", [True, False])
def test_roco_copy_writes_the_jax_rows_and_csvs(tmp_path, faithful):
    kw = {f"ROCO_{i:03d}": ["ct", "coronal", "heart", "mri", "oval",
                            "kidney"][i % 3:i % 3 + 4] for i in range(40)}
    rows = {}
    for name, mod in (("jax", jroco), ("port", proco)):
        rows[name] = mod.generate_questions(
            kw, "", seed=5, faithful=faithful, require_images=False,
            buckets=mod.default_buckets(5, faithful, include_extra=True))
        mod.write_csvs(rows[name], str(tmp_path / name), faithful=faithful,
                       seed=5)
    assert rows["port"] == rows["jax"] and len(rows["jax"]) > 40
    sub = "" if faithful else "ROCO"
    for f in ("train.csv", "test.csv"):
        assert filecmp.cmp(tmp_path / "jax" / sub / f,
                           tmp_path / "port" / sub / f, shallow=False)


def test_additional_retrieval_data_extends_the_index(data_root, tmp_path):
    """``use_additional_retrieval_data`` appends the ROCO index at
    ``additional_retrieval_cache`` (the JAX test's layout: 10 rows of
    2 * embed_dim), and hints come from the extended corpus."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(10, 128)).astype(np.float32)
    roco = RetrievalIndex(
        emb, [f"roco{i}" for i in range(10)],
        {"question_type": ["open"] * 10,
         "question_id": [str(100000 + i) for i in range(10)],
         "question": [f"rq{i}" for i in range(10)]})
    cache = str(tmp_path / "roco_cache" / "index.npz")
    roco.save(cache)
    cfg = _config(data_root, "text")
    cfg.update(use_image_info=1, use_additional_retrieval_data=1,
               additional_retrieval_cache=cache, k=2)
    cfg["hyperparameters"]["batch_size"] = 8
    exp = TrainingExperiment(cfg, device="cpu", quiet=True)
    n = len(exp.retrieval_dataset.entries)
    assert len(exp.retrieval_index) == n + 10
    assert tuple(exp.retrieval_index.embeddings.shape) == (n + 10, 128)
    assert exp.retrieval_index.answers[-10:] == roco.answers
    exp.precompute_hints("train")
    assert exp.hint_for(exp.splits["train"][0], "train").startswith(
        "I believe the answer is ")
    # without the file the index is the main corpus alone
    cfg["additional_retrieval_cache"] = str(tmp_path / "missing.npz")
    assert len(ServingExperiment(cfg, device="cpu").retrieval_index) == n


def test_synthetic_roco_index_serves(pairs, tmp_path):
    """The ROCO corpus from the port's generator, embedded by the
    experiment's CLIP into the file ``use_additional_retrieval_data``
    reads; a prediction-head server answers over the extended index."""
    kind, jexp, pexp = pairs("head")
    entries, images = synthetic_roco(6, image_size=32, seed=1)
    assert {e["image_name"] for e in entries} <= set(images)
    path = str(tmp_path / "roco" / "index.npz")
    index = build_roco_index(pexp, entries, images, path)
    assert len(index) == len(entries) and os.path.exists(path)
    cfg = dict(pexp.cfg, use_additional_retrieval_data=1,
               additional_retrieval_cache=path)
    exp = ServingExperiment(cfg, params=pexp.params, device="cpu",
                            **_splits(pexp))
    assert len(exp.retrieval_index) == len(pexp.retrieval_index) + len(
        entries)
    q = exp.retrieval_index.embeddings[-len(entries):]
    torch.testing.assert_close(q, index.embeddings, rtol=0, atol=0)
    images_, questions, tasks = _requests(jexp)
    assert len(MPRServer(exp, load_checkpoint=False).answer(
        images_, questions, tasks)) == 9


def test_variant_configs_keep_glimpse_ten(pair):
    """glimpse is 10 whatever the config says: neither experiment reads a
    key for it."""
    kind, jexp, pexp = pair
    cfg = dict(pexp.cfg, glimpse=3)
    exp = ServingExperiment(cfg, params=pexp.params, device="cpu",
                            **_splits(pexp))
    assert exp.model_cfg.glimpse == jexp.model_cfg.glimpse == 10
    if kind == "ban":
        assert len(exp.params.ban.res.b_net) == 10
