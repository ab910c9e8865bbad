"""The port's ResNet tower and its RN variant against the JAX package, on the
CPU.

Per function (fp32, within 1e-5 of the output's largest magnitude):
``resnet_grid_features`` and ``resnet_encode_image``; ``resnet_from_openai``
and ``resnet_config_from_openai_sd`` give the JAX package's leaves and
config from one OpenAI-layout state dict, whose torch module (the JAX
tests' oracle) gives the same grid features. The RN variant (fp32, dropout
off): the generative loss within 1e-5, the gradients of a train step within
1e-4 of their largest magnitude (the ResNet frozen), three AdamW steps, and
identical greedy ids. The slice, through ``vision_encoder: RN50x4`` with
tiny ``resnet_overrides``: the JAX and port servers give the same answers
(the per-batch path, the hints from the ViT), one epoch trains and tests
with the RN grid in the vision-token table and a checkpoint that crosses to
the JAX package, and ``run_from_config`` and ``cli --train --test`` take
the config.
"""

import copy
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.models import resnet as jrn  # noqa: E402
from multimodalpromptretrieval_tpu.models.clip import CLIPConfig as JCLIP  # noqa: E402
from multimodalpromptretrieval_tpu.models.t5 import T5Config as JT5  # noqa: E402
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge, cli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import mprgen as pmprgen  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import resnet as prn  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models.clip import (  # noqa: E402
    CLIPConfig as PCLIP,
)
from multimodalpromptretrieval_tpu_torch.models.t5 import T5Config as PT5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import ServingExperiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
    run_from_config,
)
from tests.test_resnet import TorchStemAndLayers  # noqa: E402

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


# two blocks in layer 1: a block without a shortcut conv
_RN = {"tiny": jrn.ResNetConfig.tiny(),
       "two_blocks": jrn.ResNetConfig(layers=(2, 1, 1, 1), width=8,
                                      embed_dim=16, heads=2,
                                      image_resolution=64)}


def _images(n=2, size=64, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module", params=list(_RN))
def tower(request):
    """(JAX config, JAX params, port config, port module): one JAX init
    bridged into the port (through an MPRGen that carries the tower)."""
    jcfg = _RN[request.param]
    pcfg = prn.ResNetConfig(**jcfg.__dict__)
    jp = jrn.init_resnet(jax.random.PRNGKey(3), jcfg)
    # the running statistics away from the identity, so that the norms'
    # arithmetic shows
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(rng.uniform(
            0.1, 0.4, size=x.shape).astype(np.float32))
        if getattr(path[-1], "key", None) in ("mean", "var") else x, jp)
    return jcfg, jp, pcfg, _port_tower(jp, pcfg)


_T5 = dict(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=1,
           num_decoder_layers=1, num_heads=2)
_CLIP = dict(embed_dim=16, image_resolution=64, vision_layers=1,
             vision_width=16, patch_size=32, context_length=16,
             vocab_size=64, text_width=16, vision_heads_override=2,
             text_heads_override=2)


def _mcfg(mod, t5, clip, rn, **kw):
    return mod.MPRGenConfig(t5=t5(**_T5), clip=clip(**_CLIP), resnet=rn, **kw)


def _port_tower(tree, pcfg):
    """A ``clip_rn`` tree (JAX layout) as the port's ResNet, through the
    bridge's name map."""
    leaves = [leaf for leaf in bridge.name_map(
        _mcfg(pmprgen, PT5, PCLIP, pcfg)) if leaf.path[0] == "clip_rn"]
    tensors = bridge.tensors_from_jax({"clip_rn": tree}, None, leaves)
    tower = prn.ResNet(pcfg)
    tower.load_state_dict({k[len("clip_rn."):]: v
                           for k, v in tensors.items()}, strict=True)
    return tower


def test_grid_features_match_jax(tower):
    jcfg, jp, pcfg, pp = tower
    x = _images()
    with torch.no_grad():
        got = prn.resnet_grid_features(pp, pcfg, torch.from_numpy(x))
    want = jrn.resnet_grid_features(jp, jcfg, jnp.asarray(x))
    assert tuple(got.shape) == (2, pcfg.grid ** 2, pcfg.final_channels)
    _rel_close(got, want)


def test_encode_image_matches_jax(tower):
    jcfg, jp, pcfg, pp = tower
    x = _images()
    with torch.no_grad():
        got = prn.resnet_encode_image(pp, pcfg, torch.from_numpy(x))
    want = jrn.resnet_encode_image(jp, jcfg, jnp.asarray(x))
    assert tuple(got.shape) == (2, pcfg.embed_dim)
    _rel_close(got, want)


def _openai_sd(layers=(2, 1, 1, 1), width=16, seed=0):
    """An OpenAI-layout state dict from the JAX tests' torch oracle (random
    running statistics) plus the attention pool's keys; and the module."""
    torch.manual_seed(seed)
    tm = TorchStemAndLayers(layers, width).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.7, 1.4)
    sd = {f"visual.{k}": v.detach().numpy()
          for k, v in tm.state_dict().items() if "num_batches" not in k}
    c, rng = width * 32, np.random.default_rng(seed)
    sd["visual.attnpool.positional_embedding"] = rng.normal(
        size=(5, c)).astype(np.float32)
    for n in ("q_proj", "k_proj", "v_proj"):
        sd[f"visual.attnpool.{n}.weight"] = rng.normal(
            size=(c, c)).astype(np.float32) * 0.02
        sd[f"visual.attnpool.{n}.bias"] = rng.normal(
            size=(c,)).astype(np.float32) * 0.02
    sd["visual.attnpool.c_proj.weight"] = rng.normal(
        size=(24, c)).astype(np.float32) * 0.02
    sd["visual.attnpool.c_proj.bias"] = np.zeros((24,), np.float32)
    return sd, tm


def test_from_openai_matches_jax_and_the_torch_module():
    sd, tm = _openai_sd()
    pcfg = prn.resnet_config_from_openai_sd(sd)
    jcfg = jrn.resnet_config_from_openai_sd(sd)
    assert pcfg.__dict__ == jcfg.__dict__
    assert pcfg.layers == (2, 1, 1, 1) and pcfg.image_resolution == 64
    tree = prn.resnet_from_openai(sd, pcfg)
    jtree = jrn.resnet_from_openai(sd, jcfg)
    got, gdef = jax.tree.flatten(tree)
    want, wdef = jax.tree.flatten(jtree)
    assert gdef == wdef
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    # the shortcut convs are where the file has them: first blocks only
    assert [("downsample" in b) for b in tree["layer1"]] == [True, False]
    x = _images(seed=4)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
        got = prn.resnet_grid_features(_port_tower(tree, pcfg), pcfg,
                                       torch.from_numpy(x))
    ref = ref.reshape(ref.shape[0], ref.shape[1], -1).transpose(1, 2)
    _rel_close(got, ref.numpy())


def test_rn50x4_config_and_parameter_count():
    """RN50x4's published shape: 2,560 channels, a 7 x 7 grid at 224 px
    (49 tokens), about 87 M parameters in the visual tower."""
    cfg = prn.ResNetConfig.rn50x4()
    assert cfg.final_channels == 2560 and cfg.heads == 40
    at224 = prn.ResNetConfig(**dict(cfg.__dict__, image_resolution=224))
    assert at224.grid ** 2 == 49
    model = prn.ResNet(cfg)  # uninitialised: shapes only
    n = sum(p.numel() for p in model.parameters())
    assert 86e6 < n < 88e6, n


# ---------------------------------------------------------------------------
# The RN variant's model functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rn_model():
    """(JAX params, JAX config, port params, port config) of a tiny RN
    model, the pad row zeroed (a random tied head re-emits its input
    token, and the decode starts from pad)."""
    jcfg = _mcfg(jmprgen, JT5, JCLIP, jrn.ResNetConfig.tiny())
    pcfg = _mcfg(pmprgen, PT5, PCLIP, prn.ResNetConfig.tiny())
    jp = jmprgen.init_mprgen(jax.random.PRNGKey(0), jcfg)
    jp["t5"]["shared"] = jp["t5"]["shared"].at[0].set(0.0)
    return jp, jcfg, bridge.params_from_jax(jp, pcfg), pcfg


def _batch(B=3, width=10, seed=7):
    rng = np.random.default_rng(seed)
    lens = (5, 9, 7)[:B]
    ids = np.zeros((B, width), np.int32)
    mask = np.zeros((B, width), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(2, 60, size=n)
        mask[i, :n] = 1
    labels = np.full((B, 4), -100, np.int32)
    labels[:, :3] = rng.integers(2, 60, size=(B, 3))
    batch = dict(images=_images(B, seed=seed), input_ids=ids, text_mask=mask,
                 labels=labels)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_rn_variant_structure(rn_model):
    _, _, pp, pcfg = rn_model
    assert pcfg.num_image_tokens == 4
    mask = pmprgen.trainable_mask(pp, pcfg)
    assert not any(v for k, v in mask.items() if k.startswith("clip_rn."))
    assert mask["rn_proj.weight"] and mask["rn_proj.bias"]
    assert tuple(pp.rn_proj.weight.shape) == (16, 8 * 32)
    seeded = pmprgen.init_mprgen(pcfg, 5)
    assert float(seeded.rn_proj.bias.detach().abs().max()) == 0.0
    bound = (8 * 32) ** -0.5
    assert float(seeded.rn_proj.weight.detach().abs().max()) <= bound


def test_rn_prefix_and_loss_match_jax(rn_model):
    jp, jcfg, pp, pcfg = rn_model
    jb, pb = _batch()
    with torch.no_grad():
        got = pmprgen.image_prefix(pp, pcfg, pb["images"])
        loss = pmprgen.loss_fn(pp, pcfg, pb)
    want = jmprgen.image_prefix(jp, jcfg, jb["images"])
    assert tuple(got.shape) == (3, 4, 16)
    _rel_close(got, want)
    jl = jax.jit(lambda p, b: jmprgen.loss_fn(p, jcfg, b))(jp, jb)
    assert abs(float(loss) - float(jl)) <= TOL


def test_rn_gradients_and_greedy_ids_match_jax(rn_model):
    jp, jcfg, pp, pcfg = rn_model
    jb, pb = _batch()
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
    assert "rn_proj.weight" in names
    for name, g in zip(names, grads):
        want = jgrads[name].numpy()
        g = np.zeros_like(want) if g is None else g.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(g - want).max())
        assert err <= 1e-4 * scale, f"{name}: {err:.3g} > 1e-4 x {scale:.3g}"
    got = pmprgen.predict_fn(pp, pcfg, pb, max_new_tokens=6)
    want = jax.jit(lambda p, b: jmprgen.predict_fn(
        p, jcfg, b, max_new_tokens=6))(jp, jb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1:] != 0).any()


def test_rn_train_steps_match_jax(rn_model):
    """Three AdamW steps at fp32 without dropout: the losses along the way
    and the parameters after them agree; the ResNet is untouched."""
    from multimodalpromptretrieval_tpu.train import optim as joptim
    from multimodalpromptretrieval_tpu_torch.train import optim as poptim
    from multimodalpromptretrieval_tpu_torch.train.step import backward

    jp, jcfg, pp, pcfg = rn_model
    jb, pb = _batch()
    jmask = jmprgen.trainable_mask(jp, jcfg)
    jopt = joptim.adamw_init(jp)
    step = jax.jit(jax.value_and_grad(
        lambda p, b: jmprgen.loss_fn(p, jcfg, b)))
    update = jax.jit(lambda p, g, o: joptim.adamw_update(
        p, g, o, 1e-3, trainable=jmask))
    pp = copy.deepcopy(pp)
    frozen = {n: p.detach().clone() for n, p in pp.named_parameters()
              if n.startswith("clip_rn.")}
    pmask = pmprgen.trainable_mask(pp, pcfg)
    pmprgen.set_trainable(pp, pmask)
    popt = poptim.adamw_init(pp)
    for _ in range(3):
        jl, g = step(jp, jb)
        jp, jopt = update(jp, g, jopt)
        pl = pmprgen.loss_fn(pp, pcfg, pb)
        poptim.adamw_update(pp, backward(pl, pp), popt, 1e-3,
                            trainable=pmask)
        assert abs(float(pl) - float(jl)) <= TOL
    want = bridge.tensors_from_jax(jp, pcfg)
    for name, p in pp.named_parameters():
        assert float((p - want[name]).abs().max()) <= 1e-4, name
        if name in frozen:
            assert torch.equal(p, frozen[name]), name


# ---------------------------------------------------------------------------
# The slice: vision_encoder RN50x4 through the experiments and the servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_resnet"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=16,
                             n_validate=8, n_test=8, image_size=64, seed=0)
    return root


_OVERRIDES = dict(layers=[1, 1, 1, 1], width=8, embed_dim=32, heads=4)


def _config(root):
    cfg = synthetic_config(root, batch_size=4, epochs=1, image_size=64,
                           retrieval=True, k=1)
    cfg["clip_overrides"].update(patch_size=32, attention_impl="row")
    cfg["t5_overrides"].update(vocab_size=117, attention_impl="row")
    cfg.update(cache_retrieval=False, vision_encoder="RN50x4",
               resnet_overrides=dict(_OVERRIDES))
    return cfg


@pytest.fixture(scope="module")
def pair(data_root):
    """(JAX Experiment, port ServingExperiment): one RN config, the JAX
    weights (pad row zeroed) bridged in."""
    cfg = _config(data_root)
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True,
                      log_root=os.path.join(data_root, "logs"),
                      model_root=os.path.join(data_root, "models"))
    jexp.params["t5"]["shared"] = jexp.params["t5"]["shared"].at[0].set(0.0)
    splits = dict(train=jexp.dataset_train.entries,
                  validate=jexp.dataset_validate.entries,
                  test=jexp.dataset_test.entries, images=jexp.images)
    probe = ServingExperiment(dict(cfg, retrieval=0), device="cpu", **splits)
    assert probe.model_cfg.resnet.__dict__ == jexp.model_cfg.resnet.__dict__
    assert probe.model_cfg.resnet.image_resolution == 64
    params = bridge.params_from_jax(jexp.params, probe.model_cfg)
    return jexp, ServingExperiment(cfg, params=params, device="cpu",
                                   **splits)


def test_rn_server_answers_match_jax(pair):
    """The 9-row request at B=4 on the per-batch path: identical answer
    strings; the retrieval hints come from the ViT in both."""
    jexp, pexp = pair
    entries = (jexp.dataset_test.entries * 2)[:9]
    images = np.stack([jexp.images[e["image_name"]] for e in entries])
    questions = [e["question"] for e in entries]
    tasks = [e["task"] for e in entries]
    want = JServer(jexp, load_checkpoint=False).answer(images, questions,
                                                        tasks)
    server = MPRServer(pexp, load_checkpoint=False)
    got = server.answer(images, questions, tasks)
    assert got == want and any(got)
    assert server.chunks == {"fused": 0, "host": 3}
    assert server.decode_steps > 0


def test_rn_train_test_and_checkpoint_cross_to_jax(pair, tmp_path):
    """One epoch with the RN grid in the vision-token table, ``test()``
    from the saved checkpoint (the prefix table from the ResNet), and the
    checkpoint loaded by the JAX package."""
    jexp, pexp = pair
    texp = TrainingExperiment(
        copy.deepcopy(pexp.cfg), params=copy.deepcopy(pexp.params),
        device="cpu", quiet=True, log_root=str(tmp_path / "logs"),
        model_root=str(tmp_path / "models"),
        train=pexp.splits["train"], validate=pexp.splits["validate"],
        test=pexp.splits["test"], images=pexp.images)
    res = texp.train()
    assert np.isfinite(res["best_valid_loss"]) and res[
        "parameter_updates"] > 0
    table = texp._vision_tokens[0]
    assert tuple(table.shape[1:]) == (4, 8 * 32)
    metrics = texp.test()
    assert sum(metrics.total.values()) == len(pexp.splits["test"])
    assert tuple(texp._prefix_dev[0].shape[1:]) == (4, 16 * 4)
    params, _, _ = jckpt.load_checkpoint(texp.model_path, jexp.params)
    back = bridge.tensors_from_jax(params, texp.model_cfg)
    for name, p in texp.params.named_parameters():
        np.testing.assert_array_equal(back[name].numpy(),
                                      p.detach().numpy(), err_msg=name)
        if name.startswith("clip_rn."):
            np.testing.assert_array_equal(
                p.detach().numpy(),
                dict(pexp.params.named_parameters())[name].detach().numpy())


def test_run_from_config_and_cli_take_rn50x4(data_root, tmp_path,
                                              monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "rn.json"
    cfg = _config(data_root)
    path.write_text(json.dumps(cfg))
    exp, _ = run_from_config(str(path), device="cpu", quiet=True)
    assert exp.model_cfg.resnet.width == 8
    assert exp.model_prefix.endswith("_retrieval_resnet")
    cli.main(["--train", "--test", "--config", str(path), "--device",
              "cpu"])
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join("models", exp.model_prefix + ".npz"))
    assert "Validation Loss" in out
