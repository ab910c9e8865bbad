"""The t5-large configuration of the port against the JAX package, on the CPU.

The JAX twin is ``tests/test_projection_path.py``; the load is the JAX
``bench.py`` ``t5_large`` stage's, cut to a tiny width: CLIP embed 64 into a
128-wide T5 (``needs_projection``: the trainable 512 -> 1024 projection of
t5-large), 2 + 2 layers, the synthetic SLAKE's open corpus (multi-token
answers). One seeded JAX init is bridged into the port, then both packages
train one epoch (3 steps of 4) under the stage's trainer overrides (the
"xla" T5 with remat, bf16 AdamW moments, a parameters-only checkpoint) at
dropout 0 and fp32: each step's loss within 1e-5 relative, the parameters
after within 1e-5 of the largest but for the elements whose gradient is
noise at some step (the packages' values apart by more than a hundredth:
AdamW's per-element normalized update turns that noise into a move of up
to lr). Neither checkpoint holds a moment. The
JAX server and the port's give identical answers on the bridged seeded
init under fp, ``quantize="int8"`` and ``spec_decode=4``; the port reads
the JAX package's checkpoint bit for bit, and its server that loads its own
checkpoint answers as the trained parameters in memory do. The port's
``t5_large_load`` and ``T5_LARGE_TRAINER`` are the JAX bench's config and
trainer overrides.

On the card (``cuda`` marker): K1, K3 and K7 at t5-large's 16 heads and
width 1024 against their plain versions (fp32 within 2e-5, 1e-5 for the
norm; bf16 within one ulp of the output's largest value).
"""

import copy
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.models import mprgen as jmprgen  # noqa: E402
from multimodalpromptretrieval_tpu.serve import MPRServer as JServer  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import serving as pserving  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import (  # noqa: E402
    _build,
    decode_attention as pdecode,
    norm as pnorm,
    row_attention as prow,
)
from multimodalpromptretrieval_tpu_torch.serve import MPRServer  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint as pckpt,
    step as psteps,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    T5_LARGE_TRAINER,
    TrainingExperiment,
)

MODES = {"fp": {}, "int8": dict(quantize="int8"),
         "spec_decode=4": dict(spec_decode=4)}


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


def _configs(root):
    """(serving config, trainer config): the t5_large stage's keys on the
    tiny widths, the trainer's T5 overrides over the serving ones."""
    cfg = synthetic_config(root, batch_size=4, epochs=1, image_size=32,
                           retrieval=True, k=1)
    cfg["T5_version"] = "t5-large"
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    # d_model 128 != CLIP's embed_dim 64: the projection
    cfg["t5_overrides"].update(d_model=128, d_kv=32, num_heads=4, d_ff=256,
                               attention_impl="row")
    cfg["cache_retrieval"] = False
    tcfg = copy.deepcopy(cfg)
    tcfg.update(copy.deepcopy(T5_LARGE_TRAINER))
    tcfg["t5_overrides"] = dict(cfg["t5_overrides"],
                                **T5_LARGE_TRAINER["t5_overrides"],
                                dropout_rate=0.0)
    return cfg, tcfg


def _recording(step, losses, jax_step, grads=None):
    """``step`` with each loss appended to ``losses`` and, with ``grads``
    (a function of the step's arguments), the step's gradients to
    ``grads.seen``, taken before the step donates its arguments."""
    def run(*args):
        if grads is not None:
            grads.seen.append(grads(*args))
        out = step(*args)
        losses.append(float(out[2] if jax_step else out))
        return out
    return run


def _noisy(grads):
    """By parameter name, the elements whose gradient is rounding noise at
    some step: the two packages' values (``grads``: a pair of per-step
    lists) apart by more than a hundredth of the larger."""
    out = {}
    for a, b in zip(*grads):
        for name, g in b.items():
            x, y = _np(a[name]), _np(g)
            noisy = np.abs(x - y) > 0.01 * np.maximum(np.abs(x), np.abs(y))
            out[name] = out.get(name, False) | noisy
    return out


def _answers(server, requests):
    images, questions, tasks, ids = requests
    return server.answer(images, questions, tasks, image_ids=ids)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_t5_large"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=4,
                             n_validate=2, n_test=4, image_size=32, seed=0,
                             answer_style="open")
    cfg, tcfg = _configs(root)
    # the vocabulary of the corpus-built tokenizer, so that every generated
    # id decodes to text
    vocab = len(ServingExperiment(dict(cfg, retrieval=0),
                                  device="cpu").tokenizer)
    for c in (cfg, tcfg):
        c["t5_overrides"]["vocab_size"] = vocab
    dirs = {name: dict(log_root=os.path.join(root, name + "_logs"),
                       model_root=os.path.join(root, name + "_models"))
            for name in ("jax", "port")}
    jexp = Experiment(tcfg, train_mode=True, quiet=True, **dirs["jax"])
    splits = dict(train=jexp.dataset_train.entries,
                  validate=jexp.dataset_validate.entries,
                  test=jexp.dataset_test.entries, images=jexp.images)
    mcfg = ServingExperiment(dict(tcfg, retrieval=0), device="cpu",
                             **splits).model_cfg
    pexp = TrainingExperiment(
        tcfg, params=bridge.params_from_jax(jexp.params, mcfg),
        device="cpu", quiet=True, **dirs["port"], **splits)
    assert pexp.model_cfg.needs_projection and pexp.model_cfg.t5.remat
    out = {"losses": ([], []), "grads": ([], [])}
    # each step's gradients: the JAX loss's at the step's arguments, the
    # port's from its step's backward
    jgrad = jax.jit(jax.grad(
        lambda p, b, r: jmprgen.loss_fn(p, jexp.model_cfg, b, r)))

    def jax_grads(params, opt_state, batch, lr, rng):
        return bridge.tensors_from_jax(jgrad(params, batch, rng),
                                       pexp.model_cfg)

    jax_grads.seen = out["grads"][0]
    jexp._train_step = _recording(jexp.train_step(), out["losses"][0], True,
                                  jax_grads)
    pexp._train_step = _recording(pexp.train_step(), out["losses"][1], False)
    out["init"] = {n: p.detach().clone()
                   for n, p in pexp.params.named_parameters()}
    backward = psteps.backward

    def kept(loss, run):
        grads = backward(loss, run)
        out["grads"][1].append({n: g.detach().clone()
                                for n, g in grads.items() if g is not None})
        return grads

    psteps.backward = kept
    try:
        out["results"] = (jexp.train(), pexp.train())
    finally:
        psteps.backward = backward
    out["params"] = (bridge.tensors_from_jax(jexp.params, pexp.model_cfg),
                     {n: p.detach().clone()
                      for n, p in pexp.params.named_parameters()})
    out["moments"] = (jexp.opt_state["mu"]["t5"]["shared"].dtype,
                      {m.dtype for m in pexp.opt_state["mu"].values()})
    out["files"] = (jexp.model_path, pexp.model_path)
    trained = copy.deepcopy(pexp.params)
    del jexp, pexp

    # the servers of the seeded init, bridged: a random tied head re-emits
    # its input token and the decode starts from pad, so the pad embedding
    # is zeroed for answers that carry text (the trained checkpoint answers
    # EOS first: after 3 steps the most frequent label wins)
    jsexp = Experiment(cfg, train_mode=False, quiet=True, **dirs["jax"])
    shared = jsexp.params["t5"]["shared"]
    jsexp.params["t5"]["shared"] = shared.at[0].set(0.0)
    psexp = ServingExperiment(
        cfg, params=bridge.params_from_jax(jsexp.params, mcfg), device="cpu",
        model_root=dirs["port"]["model_root"], **splits)
    entries = jsexp.dataset_test.entries
    requests = (np.stack([jsexp.images[e["image_name"]] for e in entries]),
                [e["question"] for e in entries],
                [e["task"] for e in entries],
                [e["image_name"] for e in entries])
    out["answers"] = {
        name: (_answers(JServer(jsexp, load_checkpoint=False, **options),
                        requests),
               _answers(MPRServer(psexp, load_checkpoint=False, **options),
                        requests))
        for name, options in MODES.items()}
    # the checkpoints: the JAX package's file read by the port, then the
    # port's own file served against the trained parameters in memory
    out["jax_file"] = pckpt.load_checkpoint(out["files"][0], mcfg)[0]
    out["own_file"] = _answers(MPRServer(psexp, load_checkpoint=True),
                               requests)
    out["loaded"] = {n: p.detach().clone()
                     for n, p in psexp.params.named_parameters()}
    psexp.params = trained
    out["in_memory"] = _answers(MPRServer(psexp, load_checkpoint=False),
                                requests)
    out["n"] = len(entries)
    return out


def test_trainer_overrides_are_the_jax_bench_stage():
    """``T5_LARGE_TRAINER`` is the JAX bench's t5-large trainer overrides
    (its epochs aside: one epoch here)."""
    import bench

    args = bench.build_parser().parse_args([])
    want = bench._t5_large_trainer_overrides(args)
    want.pop("epochs")
    assert T5_LARGE_TRAINER == want


def test_t5_large_load_is_the_jax_bench_load(tmp_path, monkeypatch):
    """``t5_large_load``'s config is the JAX bench's ``_bench_setup`` for
    the t5_large stage (``--t5-large-batch`` 128, the open corpus), and its
    data the same generator's draws: 410 corpus, 8 validation and 512 test
    images at 224 px (the draws are stubbed here: 1,536 questions at 224 px
    do not belong on the CPU)."""
    import bench

    args = bench._t5_large_args(bench.build_parser().parse_args([]))
    marker = tmp_path / "full_open" / "SLAKE" / "test.json"
    marker.parent.mkdir(parents=True)
    marker.write_text("[]")  # the dataset "exists": nothing is generated
    want, _, _ = bench._bench_setup(args, str(tmp_path), False, "open")
    calls = []
    monkeypatch.setattr(pserving, "synthetic_slake",
                        lambda *a, **kw: calls.append((a, kw)) or ({}, {}))
    got, _, _ = pserving.t5_large_load(seed=0)
    for key in ("datafolder", "retrieval_cache_dir"):
        del want[key]
    # the port's loads seed the weights with their seed argument, the JAX
    # bench with the synthetic config's 88
    assert want.pop("seed") == 88 and got.pop("seed") == 0
    assert got == want
    assert calls == [((410, 512), dict(image_size=224, seed=0, n_validate=8,
                                       answer_style="open"))]


def test_three_steps_match_jax(runs):
    jl, pl = runs["losses"]
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    jres, pres = runs["results"]
    assert pres["parameter_updates"] == jres["parameter_updates"] == 3
    assert pl[-1] < pl[0]


def test_parameters_after_match_jax(runs):
    """Within 1e-5 of the largest value, every element but those whose
    gradient is noise at some step (:func:`_noisy`): AdamW divides each
    element's moment by its own RMS, so its update lr * m / (sqrt(v) +
    1e-8) is as uncertain as its gradient is relative to itself, and an
    element whose gradient is rounding noise near 0 moves by up to lr in
    one package and not in the other (two summation orders on one CPU do
    the same). Those set aside are few: at most one trained element in
    1,000."""
    want, got = runs["params"]
    noisy = _noisy(runs["grads"])
    assert len(runs["grads"][0]) == len(runs["grads"][1]) == 3
    assert sorted(noisy) == sorted(n for n in want
                                   if not n.startswith("clip."))
    largest = max(np.abs(_np(w)).max() for w in want.values())
    tol = 1e-5 * largest
    for name, w in want.items():
        diff = np.abs(_np(got[name]) - _np(w))
        held = diff[~noisy[name]] if name in noisy else diff
        assert held.max(initial=0.0) <= tol, (name, held.max(), tol)
        if name.startswith("clip."):
            np.testing.assert_array_equal(_np(got[name]), _np(w))
    trained = sum(x.size for x in noisy.values())
    assert sum(int(x.sum()) for x in noisy.values()) <= trained // 1000


def test_projection_and_t5_train_clip_stays(runs):
    """bf16 moments on both sides; in the port, the projection and every
    T5 leaf moved, the CLIP towers did not."""
    jdt, pdt = runs["moments"]
    assert str(jdt) == "bfloat16" and pdt == {torch.bfloat16}
    start, end = runs["init"], runs["params"][1]
    assert end["proj.weight"].shape == (128, 64)
    for name, p in end.items():
        assert torch.equal(p, start[name]) == name.startswith("clip."), name


@pytest.mark.parametrize("package", ["jax", "port"])
def test_checkpoint_holds_parameters_only(runs, package):
    path = runs["files"][package == "port"]
    with np.load(path) as z:
        keys = set(z.files)
    assert keys and all(k.startswith("params/") for k in keys)
    with open(path + ".json") as f:
        assert json.load(f)["config"]["checkpoint_save_optimizer"] == 0


def test_both_checkpoints_have_one_layout(runs):
    with np.load(runs["files"][0]) as a, np.load(runs["files"][1]) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("mode", list(MODES))
def test_served_answers_match_jax(runs, mode):
    want, got = runs["answers"][mode]
    assert len(got) == runs["n"] and got == want
    assert any(a for a in got)


def test_speculative_answers_are_the_lockstep_ones(runs):
    assert runs["answers"]["spec_decode=4"][1] == runs["answers"]["fp"][1]


def test_port_reads_the_jax_checkpoint_bit_for_bit(runs):
    got = dict(runs["jax_file"].named_parameters())
    for name, want in runs["params"][0].items():
        assert torch.equal(got[name], want), name


def test_loaded_checkpoint_answers_as_the_trained_parameters(runs):
    assert runs["own_file"] == runs["in_memory"]
    want = runs["params"][1]
    for name, p in runs["loaded"].items():
        assert torch.equal(p, want[name]), name


# ---------------------------------------------------------------------------
# On the card: K1, K3, K7 at t5-large's 16 heads and width 1024
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, ref, fp32=2e-5):
    if dtype == "float32":
        return fp32
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_row_attention_at_16_heads(dtype):
    """K1 over the T5 encoder's packed (B, 114, 3072) qkv at 16 heads, the
    (16, 114, 114) bias and a key mask, T5's scale 1.0."""
    dev, dt = _card(), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    B, L, H, W = 8, 114, 16, 1024
    qkv = _normal(rng, B, L, 3 * W)
    qkv[..., :W] *= 0.125
    bias = _normal(rng, H, L, L)
    mask = torch.ones((B, L), dtype=torch.int32)
    mask[0, L - 9:] = 0
    mask[-1, L // 2:] = 0
    args = [x.to(dev) for x in (qkv.to(dt), bias.to(dt), mask)]
    before = _build.launch_counts()["row_attention_packed"]
    got = prow.row_attention_packed(*args, heads=H, scale=1.0)
    want = prow.row_attention_packed_reference(*args, heads=H, scale=1.0)
    torch.cuda.synchronize()
    assert _build.launch_counts()["row_attention_packed"] == before + 1
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rms_norm_at_width_1024(dtype):
    """K3 at d_model 1024: the BLOCK_W 1024, 8-warp launch."""
    dev, dt = _card(), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = (_normal(rng, 8 * 114, 1024) * 2 + 0.5).to(dev, dt)
    w = _normal(rng, 1024).to(dev, dt)
    before = _build.launch_counts()["fused_rms_norm"]
    got = pnorm.fused_rms_norm(x, w)
    want = pnorm.fused_rms_norm_reference(x, w)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_rms_norm"] == before + 1
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=_tol(dtype, ref, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["self", "cross"])
def test_cuda_decode_attention_at_width_1024(dtype, case):
    """K7 at W = 1024, 16 heads (blocks of 512 threads): self-attention
    over T = 20 slots with the (16, 20) bias, q a column slice of the
    (B, 3072) projections; cross-attention over 114 keys with a mask."""
    dev, dt = _card(), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    B, H, W = 8, 16, 1024
    T = 20 if case == "self" else 114
    k, v = (_normal(rng, B, T, W).to(dev, dt) for _ in range(2))
    if case == "self":
        q = _normal(rng, B, 3 * W).to(dev, dt)[:, :W]
        bias, mask = _normal(rng, H, T).to(dev), None
    else:
        q, bias = _normal(rng, B, W).to(dev, dt), None
        mask = torch.ones((B, T), dtype=torch.int32)
        mask[1, 60:] = 0
        mask = mask.to(dev)
    before = _build.launch_counts()["decode_attention_fused"]
    got = pdecode.decode_attention_fused(q, k, v, bias, mask, heads=H)
    want = pdecode.decode_attention_indicator_reference(q, k, v, bias, mask,
                                                        heads=H)
    torch.cuda.synchronize()
    assert _build.launch_counts()["decode_attention_fused"] == before + 1
    ref = _np(want)
    np.testing.assert_allclose(_np(got), ref, rtol=0, atol=_tol(dtype, ref))
