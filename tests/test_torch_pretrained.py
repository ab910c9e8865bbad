"""The port's checkpoint converters, exporters and mapping trainer against
the JAX package, on the CPU.

Converters, on random state dicts in each layout: ``t5_from_hf`` (relu and
gated-gelu HF ``T5ForConditionalGeneration``) gives the JAX converter's
leaves exactly, and the model made of them matches HF's encoder states and
logits at fp32 within 1e-5 of their largest magnitude;
``resize_token_embeddings`` shrinks exactly and grows with the kept rows;
``clip_config_from_openai_sd`` / ``clip_from_openai`` / ``clip_from_hf``
give the JAX config and leaves, and the image tokens and text embeddings
within 1e-5 (of JAX's, and of HF's); ``mprgen_from_reference_checkpoint``
gives JAX's leaves for the base, t5-large-projection, RN, mapping, head and
BAN variants (the RN case's random ViT excepted). Exporters: the JAX
exporters' keys and arrays, export -> convert is the identity, and the T5
export loads strictly into HF. Mapping: ``contrastive_loss`` and an AdamW
step within 1e-6 relative, ``train_mapping``'s trajectory within 1e-5 from
the same initial weights and seed, ``retrieval_accuracy`` and ``pca_2d``
equal, and mapping checkpoints written by either package load in the
other, the port's ``create_mapping`` entry point's among them.
"""

import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.models import clip as jclip  # noqa: E402
from multimodalpromptretrieval_tpu.models import convert as jconvert  # noqa: E402
from multimodalpromptretrieval_tpu.models import export as jexport  # noqa: E402
from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.models import resnet as jrn  # noqa: E402
from multimodalpromptretrieval_tpu.models import t5 as jt5  # noqa: E402
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu.train import mapping as jmapping  # noqa: E402
from multimodalpromptretrieval_tpu.train import optim as joptim  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import create_mapping  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import clip as pclip  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import convert as pconvert  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import export as pexport  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import resnet as prn  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import t5 as pt5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import checkpoint as pckpt  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import mapping as pmapping  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import optim as poptim  # noqa: E402
from tests.test_clip_openai_convert import (  # noqa: E402
    OpenAIBlock,
    _export_openai_sd,
)
from tests.test_torch_resnet import _openai_sd as _openai_rn_sd  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    scale = max(np.max(np.abs(want)), 1e-12)
    assert err <= tol * scale, f"max abs error {err:.3g} > {tol} x {scale:.3g}"


def _trees_equal(got, want, skip=()):
    """Same structure, every leaf bit-equal and float32 (``skip``: top-level
    keys left out)."""
    got = {k: v for k, v in got.items() if k not in skip}
    want = {k: v for k, v in want.items() if k not in skip}
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        assert np.asarray(a).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


_T5 = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
           num_decoder_layers=2, num_heads=4)
_CLIP = dict(embed_dim=16, image_resolution=32, vision_width=32,
             vision_layers=2, patch_size=16, context_length=12,
             vocab_size=64, text_width=24, text_layers=2)


def _cfgs(clip=None, **kw):
    """(JAX, port) MPRGenConfig of one tiny variant; ``resnet`` in ``kw``
    is a ResNetConfig's fields."""
    clip = dict(_CLIP, **(clip or {}))
    rn = kw.pop("resnet", None)
    out = []
    for mod, t5, cl, r in ((jmprgen, jt5, jclip, jrn),
                           (pmprgen, pt5, pclip, prn)):
        out.append(mod.MPRGenConfig(
            t5=t5.T5Config(**_T5), clip=cl.CLIPConfig(**clip),
            resnet=r.ResNetConfig(**rn) if rn else None, **kw))
    return out


def _port_model(tree, pcfg, seed=0):
    """The port's model of a (partial) JAX-layout tree: the parts it holds
    over a seeded init, as ``ServingExperiment`` loads checkpoints."""
    full = bridge.tree_numpy(bridge.params_to_jax(
        pmprgen.init_mprgen(pcfg, seed), pcfg))
    full.update(tree)
    return bridge.params_from_jax(full, pcfg)


# ---------------------------------------------------------------------------
# T5 (HF layout)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["relu", "gated-gelu"])
def hf_t5(request):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(HFT5Config(
        dropout_rate=0.0, decoder_start_token_id=0,
        feed_forward_proj=request.param, tie_word_embeddings=True,
        **_T5)).eval()
    return request.param, hf


def test_t5_from_hf_matches_jax_and_hf(hf_t5):
    ff, hf = hf_t5
    jcfg, pcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, t5=dataclasses.replace(
        jcfg.t5, feed_forward_proj=ff))
    pcfg = dataclasses.replace(pcfg, t5=dataclasses.replace(
        pcfg.t5, feed_forward_proj=ff))
    sd = pconvert.state_dict_to_numpy(hf.state_dict())
    tree = pconvert.t5_from_hf(sd, pcfg.t5)
    _trees_equal(tree, jconvert.t5_from_hf(sd, jcfg.t5))
    model = _port_model({"t5": tree}, pcfg).t5
    rng = np.random.default_rng(1)
    embeds = rng.normal(size=(3, 11, 32)).astype(np.float32)
    mask = np.ones((3, 11), np.int64)
    mask[0, -3:] = 0
    labels = rng.integers(2, 96, size=(3, 7))
    e, m = torch.from_numpy(embeds), torch.from_numpy(mask)
    with torch.no_grad():
        ref = hf(inputs_embeds=e, attention_mask=m,
                 labels=torch.from_numpy(labels))
        enc = pt5.t5_encode(model, pcfg.t5, e, m)
        logits = pt5.t5_decode_train(
            model, pcfg.t5, enc, m,
            pt5.shift_right(torch.from_numpy(labels), pcfg.t5))
    _rel_close(enc, ref.encoder_last_hidden_state.numpy())
    _rel_close(logits, ref.logits.numpy())


def test_resize_token_embeddings_shrinks_exactly_and_grows():
    rng = np.random.default_rng(0)
    tree = {"shared": rng.normal(size=(96, 8)).astype(np.float32),
            "encoder": {}}
    small = pconvert.resize_token_embeddings(tree, 90)
    np.testing.assert_array_equal(
        small["shared"], np.asarray(jconvert.resize_token_embeddings(
            {"shared": jnp.asarray(tree["shared"])}, 90)["shared"]))
    assert small["encoder"] is tree["encoder"]
    big = pconvert.resize_token_embeddings(tree, 100, seed=3)
    want = jconvert.resize_token_embeddings(
        {"shared": jnp.asarray(tree["shared"])}, 100)["shared"]
    assert big["shared"].shape == want.shape == (100, 8)
    assert big["shared"].dtype == np.float32
    np.testing.assert_array_equal(big["shared"][:96], tree["shared"])
    np.testing.assert_array_equal(
        big["shared"],
        pconvert.resize_token_embeddings(tree, 100, seed=3)["shared"])


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def openai_clip():
    torch.manual_seed(0)
    vblocks = [OpenAIBlock(32, 1).eval() for _ in range(2)]
    tblocks = [OpenAIBlock(24, 1).eval() for _ in range(2)]
    return _export_openai_sd(vblocks, 32, 16, 2, 16, 64, 12, 24, tblocks)


def _clip_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(2, 3, cfg.image_resolution,
                              cfg.image_resolution)).astype(np.float32)
    L = cfg.context_length
    ids = rng.integers(1, cfg.vocab_size - 2, size=(3, L))
    for b, pos in enumerate([4, L - 1, 7]):
        ids[b, pos] = cfg.vocab_size - 1  # EOT, the highest id
        ids[b, pos + 1:] = 0
    return images, ids.astype(np.int64)


def _port_clip(tree, cfg):
    """A ``clip`` tree as the port's CLIP (through a tiny model)."""
    jcfg, pcfg = _cfgs(clip=dataclasses.asdict(cfg))
    return _port_model({"clip": tree}, pcfg).clip, pcfg.clip


def test_clip_from_openai_matches_jax(openai_clip):
    sd = openai_clip
    cfg = pconvert.clip_config_from_openai_sd(sd)
    jcfg = jconvert.clip_config_from_openai_sd(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = pconvert.clip_from_openai(sd, cfg)
    jtree = jconvert.clip_from_openai(sd, jcfg)
    _trees_equal(tree, jtree)
    model, cfg = _port_clip(tree, cfg)
    images, ids = _clip_inputs(cfg)
    with torch.no_grad():
        tokens = pclip.clip_image_tokens(model, cfg, torch.from_numpy(images))
        text = pclip.clip_encode_text(model, cfg, torch.from_numpy(ids))
    _rel_close(tokens, jclip.clip_image_tokens(jtree, jcfg,
                                               jnp.asarray(images)))
    _rel_close(text, jclip.clip_encode_text(jtree, jcfg, jnp.asarray(ids)))


def test_clip_from_hf_matches_jax_and_hf():
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel

    cfg = pclip.CLIPConfig(**dict(_CLIP, vision_heads_override=2,
                                  text_heads_override=2))
    torch.manual_seed(0)
    common = dict(hidden_act="quick_gelu", attention_dropout=0.0)
    hf = CLIPModel(HFCLIPConfig(
        projection_dim=cfg.embed_dim,
        vision_config=dict(hidden_size=cfg.vision_width,
                           intermediate_size=cfg.vision_width * 4,
                           num_hidden_layers=cfg.vision_layers,
                           num_attention_heads=cfg.vision_heads,
                           image_size=cfg.image_resolution,
                           patch_size=cfg.patch_size, **common),
        text_config=dict(hidden_size=cfg.text_width,
                         intermediate_size=cfg.text_width * 4,
                         num_hidden_layers=cfg.text_layers,
                         num_attention_heads=cfg.text_heads,
                         max_position_embeddings=cfg.context_length,
                         vocab_size=cfg.vocab_size,
                         eos_token_id=cfg.vocab_size - 1,
                         bos_token_id=cfg.vocab_size - 2, pad_token_id=0,
                         **common))).eval()
    sd = pconvert.state_dict_to_numpy(hf.state_dict())
    tree = pconvert.clip_from_hf(sd, cfg)
    jcfg = jclip.CLIPConfig(**dataclasses.asdict(cfg))
    _trees_equal(tree, jconvert.clip_from_hf(sd, jcfg))
    model, _ = _port_clip(tree, cfg)
    images, ids = _clip_inputs(cfg, seed=5)
    with torch.no_grad():
        tokens = pclip.clip_image_tokens(model, cfg, torch.from_numpy(images))
        text = pclip.clip_encode_text(model, cfg, torch.from_numpy(ids))
        out = hf.vision_model(pixel_values=torch.from_numpy(images))
        ref_tokens = hf.visual_projection(
            hf.vision_model.post_layernorm(out.last_hidden_state))
        ref_text = hf.get_text_features(input_ids=torch.from_numpy(ids))
    _rel_close(tokens, ref_tokens.numpy())
    _rel_close(text, ref_text.numpy())


# ---------------------------------------------------------------------------
# Whole models: the reference's layout, both ways
# ---------------------------------------------------------------------------

_VARIANTS = {
    "base": dict(clip=dict(embed_dim=32)),
    "t5_large_projection": dict(),
    "rn": dict(clip=dict(embed_dim=32),
               resnet=dict(layers=(2, 1, 1, 1), width=16, embed_dim=24,
                           heads=8, image_resolution=64)),
    "mapping": dict(use_mapping=True),
    "head": dict(use_prediction_head=True, num_classes=5),
    "ban": dict(use_prediction_head=True, use_ban=True, num_classes=5,
                glimpse=2),
}


@pytest.fixture(scope="module", params=list(_VARIANTS))
def variant(request):
    """(name, JAX config, port config, params in the JAX layout as numpy
    (the port's seeded init), the reference state dict the JAX exporter
    writes of them; for RN, the ResNet under ``vision_model.`` in OpenAI's
    layout in place of the ViT)."""
    jcfg, pcfg = _cfgs(**copy.deepcopy(_VARIANTS[request.param]))
    assert jcfg.needs_projection == (request.param != "base"
                                     and request.param != "rn")
    jp = bridge.tree_numpy(bridge.params_to_jax(
        pmprgen.init_mprgen(pcfg, 4), pcfg))
    sd = jexport.mprgen_to_reference_state_dict(jp, jcfg)
    if request.param == "rn":
        rn_sd, _ = _openai_rn_sd()
        sd = {k: v for k, v in sd.items()
              if not k.startswith("vision_model.")}
        sd.update({f"vision_model.{k}": v for k, v in rn_sd.items()})
    return request.param, jcfg, pcfg, jp, sd


def test_reference_checkpoint_matches_jax(variant):
    name, jcfg, pcfg, _, sd = variant
    got = pconvert.mprgen_from_reference_checkpoint(sd, pcfg)
    want = jconvert.mprgen_from_reference_checkpoint(sd, jcfg)
    # the RN model's ViT is random in both (their own draws)
    _trees_equal(got, want, skip=("clip",) if name == "rn" else ())
    assert ("clip_rn" in got) == (name == "rn")
    if name == "rn":
        seeded = pconvert.mprgen_from_reference_checkpoint(sd, pcfg)["clip"]
        _trees_equal(got["clip"], seeded)
        assert got["clip"]["visual"]["conv1"].shape == np.shape(
            want["clip"]["visual"]["conv1"])
    # the model the port makes of it (a reference checkpoint fills every
    # part the variant has)
    model = bridge.params_from_jax(got, pcfg)
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == set(got)


def test_exporters_match_jax_and_round_trip(variant):
    name, jcfg, pcfg, jp, _ = variant
    for fn, args in (("t5_to_hf", (jp["t5"], pcfg.t5)),
                     ("clip_to_openai", (jp["clip"], pcfg.clip)),
                     ("mprgen_to_reference_state_dict", (jp, pcfg))):
        got = getattr(pexport, fn)(*args)
        want = getattr(jexport, fn)(*((jp["t5"], jcfg.t5) if fn == "t5_to_hf"
                                      else (jp["clip"], jcfg.clip)
                                      if fn == "clip_to_openai"
                                      else (jp, jcfg)))
        assert set(got) == set(want), fn
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{fn} {k}")
    # export -> convert is the identity (an RN model exports its ViT and
    # rn_proj, not its ResNet)
    back = pconvert.mprgen_from_reference_checkpoint(
        pexport.mprgen_to_reference_state_dict(jp, pcfg), pcfg)
    keep = {k: v for k, v in jp.items() if k != "clip_rn"}
    _trees_equal(back, keep)
    # and through the port's modules: params -> tree -> export
    model = bridge.params_from_jax(jp, pcfg)
    tree = bridge.tree_numpy(bridge.params_to_jax(model, pcfg))
    sd = pexport.mprgen_to_reference_state_dict(tree, pcfg)
    for k, v in jexport.mprgen_to_reference_state_dict(jp, jcfg).items():
        np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)


def test_t5_export_loads_strictly_into_hf():
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    _, pcfg = _cfgs()
    tree = bridge.tree_numpy(bridge.params_to_jax(
        pmprgen.init_mprgen(pcfg, 2), pcfg))
    sd = pexport.t5_to_hf(tree["t5"], pcfg.t5)
    hf = T5ForConditionalGeneration(HFT5Config(
        tie_word_embeddings=True, feed_forward_proj="relu", **_T5))
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    assert not unexpected
    assert not [m for m in missing if "lm_head" not in m], missing
    np.testing.assert_array_equal(hf.shared.weight.detach().numpy(),
                                  tree["t5"]["shared"])


# ---------------------------------------------------------------------------
# The mapping MLP and its trainer
# ---------------------------------------------------------------------------


def _paired(n=96, d=32, seed=0):
    """Text features a fixed linear map of the image features plus noise:
    an alignment the mapping can learn."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, d)).astype(np.float32) / np.sqrt(d)
    txt = img @ w + 0.01 * rng.normal(size=(n, d))
    return img, txt.astype(np.float32)


def _mapping_pair(d=32, seed=0):
    jp = jmprgen.init_mapping(jax.random.PRNGKey(seed), d)
    return jp, bridge.mapping_from_jax(jax.tree.map(np.asarray, jp))


def test_mapping_apply_and_contrastive_loss_match_jax():
    img, txt = _paired()
    jp, pp = _mapping_pair()
    with torch.no_grad():
        mapped = pmprgen.mapping_apply(pp, torch.from_numpy(img))
        loss = pmapping.contrastive_loss(pp, torch.from_numpy(img),
                                         torch.from_numpy(txt))
    _rel_close(mapped, jmprgen.mapping_apply(jp, jnp.asarray(img)), 1e-6)
    want = float(jmapping.contrastive_loss(jp, jnp.asarray(img),
                                           jnp.asarray(txt)))
    assert abs(float(loss) - want) <= 1e-6 * abs(want)


def test_mapping_adamw_step_matches_jax():
    img, txt = _paired(n=32)
    jp, pp = _mapping_pair()
    loss, grads = jax.value_and_grad(jmapping.contrastive_loss)(
        jp, jnp.asarray(img), jnp.asarray(txt))
    jp2, _ = joptim.adamw_update(jp, grads, joptim.adamw_init(jp), 1e-3)
    named = dict(pp.named_parameters())
    ploss = pmapping.contrastive_loss(pp, torch.from_numpy(img),
                                      torch.from_numpy(txt))
    pgrads = dict(zip(named, torch.autograd.grad(ploss, list(
        named.values()))))
    want = bridge.tensors_from_jax(grads, None, bridge.MAPPING_LEAVES)
    for k, g in pgrads.items():
        _rel_close(g, want[k].numpy(), 1e-6)
    poptim.adamw_update(pp, pgrads, poptim.adamw_init(pp), 1e-3)
    after = bridge.tensors_from_jax(jp2, None, bridge.MAPPING_LEAVES)
    for k, p in pp.named_parameters():
        _rel_close(p, after[k].numpy(), 1e-6)


def test_train_mapping_runs_on_the_card_unless_asked(monkeypatch):
    """Like the port's other entry points, ``train_mapping`` without a
    device asks for the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, txt = _paired(n=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmapping.train_mapping(img, txt, epochs=1, batch_size=32)


@pytest.mark.parametrize("epochs", [1, 3])
def test_train_mapping_follows_the_jax_trajectory(epochs):
    """The same seed (the JAX initial weights, the same permutations and
    drop-last batches): the full-data loss and the parameters after each
    run within 1e-5."""
    img, txt = _paired(n=80)
    jp = jmapping.train_mapping(img, txt, epochs=epochs, batch_size=32,
                                lr=1e-3, seed=2)
    _, init = _mapping_pair(seed=2)
    losses = []
    pp = pmapping.train_mapping(img, txt, epochs=epochs, batch_size=32,
                                lr=1e-3, seed=2, init=init, losses=losses,
                                device="cpu")
    assert len(losses) == 2 * epochs  # 80 rows: two batches of 32 an epoch
    want = float(jmapping.contrastive_loss(jp, jnp.asarray(img),
                                           jnp.asarray(txt)))
    with torch.no_grad():
        got = float(pmapping.contrastive_loss(pp, torch.from_numpy(img),
                                              torch.from_numpy(txt)))
    assert abs(got - want) <= TOL * abs(want)
    ref = bridge.tensors_from_jax(jp, None, bridge.MAPPING_LEAVES)
    for k, p in pp.named_parameters():
        _rel_close(p, ref[k].numpy())


def test_retrieval_accuracy_and_pca_match_jax():
    img, txt = _paired()
    jp, pp = _mapping_pair()
    for k in (1, 5):
        assert pmapping.retrieval_accuracy(pp, img, txt, k=k) == \
            jmapping.retrieval_accuracy(jp, img, txt, k=k)
    x = np.random.default_rng(3).normal(size=(40, 16))
    np.testing.assert_array_equal(pmapping.pca_2d(x), jmapping.pca_2d(x))
    a, b = pmapping.visualize_mapping(pp, img[:24], txt[:24])
    assert a.shape == b.shape == (24, 2)


def test_mapping_checkpoints_cross_both_ways(tmp_path):
    jp, pp = _mapping_pair(seed=5)
    path = str(tmp_path / "port.npz")
    pckpt.save_mapping(path, pp)
    loaded, _, _ = jckpt.load_checkpoint(path, jp)
    _trees_equal(jax.tree.map(np.asarray, loaded),
                 jax.tree.map(np.asarray, jp))
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jp)
    back = bridge.mapping_from_jax(pckpt.load_mapping_tree(path))
    for k, p in back.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      dict(pp.named_parameters())[k]
                                      .detach().numpy())


def test_create_mapping_entry_point_writes_a_jax_checkpoint(tmp_path,
                                                            capsys):
    img, txt = _paired(n=64)
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, clip_image_features=img, t5_text_features=txt)
    out = str(tmp_path / "mapping.npz")
    create_mapping.main(["--features", feats, "--epochs", "20",
                         "--batch-size", "32", "--lr", "1e-3", "--out", out,
                         "--device", "cpu"])
    printed = capsys.readouterr().out
    acc = float(printed.strip().splitlines()[-1].split()[-1])
    template = jmprgen.init_mapping(jax.random.PRNGKey(0), 32)
    loaded, _, _ = jckpt.load_checkpoint(out, template)
    trained = jmapping.retrieval_accuracy(loaded, img, txt, k=5)
    assert trained == pytest.approx(acc, abs=1e-3)
    assert trained > jmapping.retrieval_accuracy(template, img, txt, k=5)
