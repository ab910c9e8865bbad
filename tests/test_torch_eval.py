"""The port's ``--eval`` attention maps, profiling hooks and FLOP counts
against the JAX package, on the CPU.

One synthetic SLAKE on disk (32-px images), one config (fp32, the
head-layout attention, which the JAX package runs fastest on the CPU), one
seeded JAX init (pad embedding zeroed, so that the answers
carry text) bridged into the port. ``t5_forward_with_attentions`` gives the
JAX function's five outputs within 1e-5; ``attention_maps`` of one test
entry gives identical ids and maps within 1e-5; the figures land at the
JAX package's paths (``figures/<qid>/head<j>/attention<i>.pdf``), for
``--qid`` and for ``correct_ids.txt``; ``cli.main(["--eval", "--qid",
...])`` loads the JAX package's checkpoint and writes every (layer, head)
figure from the JAX maps. ``StepTimer.summary()`` equals the JAX one,
``trace`` writes a Chrome trace on the CPU, and every ``ops/flops``
function gives the JAX integer for t5-small, t5-large, ViT-B/32 and the
text tower.
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
from multimodalpromptretrieval_tpu.models import clip as jclip  # noqa: E402
from multimodalpromptretrieval_tpu.models import t5 as jt5  # noqa: E402
from multimodalpromptretrieval_tpu.ops import flops as jflops  # noqa: E402
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu.train import profiling as jprofiling  # noqa: E402
from multimodalpromptretrieval_tpu.train import visualize as jvisualize  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch import cli  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import clip as pclip  # noqa: E402
from multimodalpromptretrieval_tpu_torch.models import t5 as pt5  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import flops as pflops  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)
from multimodalpromptretrieval_tpu_torch.train import profiling  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import visualize  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)

TOL = 1e-5
MAPS = ("encoder_attentions", "cross_attentions")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exps(tmp_path_factory):
    """(JAX Experiment, port TrainingExperiment with its weights, config,
    root)."""
    root = str(tmp_path_factory.mktemp("torch_eval"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=4,
                             n_validate=2, n_test=4, image_size=32, seed=0)
    cfg = synthetic_config(root, batch_size=8, epochs=1, image_size=32)
    cfg["clip_overrides"].update(patch_size=16)
    cfg["t5_overrides"].update(dropout_rate=0.0, vocab_size=128)
    # one device for the JAX package
    cfg["parallelism"] = {"data": 1}
    paths = dict(log_root=os.path.join(root, "logs"),
                 model_root=os.path.join(root, "models"))
    jexp = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True,
                      **paths)
    # a random tied head re-emits its input token, and the decode starts
    # from pad: a zero pad embedding lets the answers carry text
    jexp.params["t5"]["shared"] = jexp.params["t5"]["shared"].at[0].set(0.0)
    probe = ServingExperiment(copy.deepcopy(cfg), device="cpu")
    pexp = TrainingExperiment(
        copy.deepcopy(cfg), device="cpu", train_mode=False, quiet=True,
        params=bridge.params_from_jax(jexp.params, probe.model_cfg), **paths)
    return jexp, pexp, cfg, root


@pytest.fixture(scope="module")
def jax_maps(exps):
    """The JAX ``attention_maps`` of the first test entry."""
    jexp = exps[0]
    return jvisualize.attention_maps(jexp, jexp.dataset_test.entries[0])


def _close(got, want, what):
    want = np.asarray(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_with_attentions_matches_jax(exps, masked):
    """The five outputs of a teacher-forced forward over (B=2, L=7) input
    embeddings and (B, 5) decoder ids, with or without a key mask."""
    jexp, pexp = exps[:2]
    cfg = jexp.model_cfg.t5
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    if masked:
        mask[1, 4:] = 0
    ids = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    want = jt5.t5_forward_with_attentions(
        jexp.params["t5"], cfg, jnp.asarray(embeds),
        jnp.asarray(mask) if masked else None, jnp.asarray(ids))
    got = pt5.t5_forward_with_attentions(
        pexp.params.t5, pexp.model_cfg.t5, torch.from_numpy(embeds),
        torch.from_numpy(mask) if masked else None, torch.from_numpy(ids))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k].numpy(), want[k], k)
    assert got["logits"].dtype == torch.float32


def test_attention_maps_match_jax(exps, jax_maps):
    """One test entry: the prompt ids and the generated ids identical, the
    answer string identical, the maps within 1e-5; each probability row
    sums to 1."""
    pexp = exps[1]
    entry = pexp.datasets["test"].entries[0]
    got = visualize.attention_maps(pexp, entry)
    assert got["input_ids"] == list(jax_maps["input_ids"])
    np.testing.assert_array_equal(got["output_ids"], jax_maps["output_ids"])
    assert got["predicted_answer"] == jax_maps["predicted_answer"]
    assert got["predicted_answer"]
    for k in MAPS:
        assert got[k].shape == jax_maps[k].shape
        _close(got[k], jax_maps[k], k)
    for k in MAPS + ("decoder_attentions",):
        np.testing.assert_allclose(got[k].sum(-1), 1.0, rtol=0, atol=1e-5)


def _figures(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_figures_written_at_the_jax_paths(exps, jax_maps, tmp_path,
                                         monkeypatch):
    """``visualize_correct_ids`` with a ``qid`` writes the JAX package's
    files (from its maps of this question, computed once by the fixture):
    one PDF per (layer, head) under ``<qid>/head<j>/attention<i>.pdf``; the
    encoder maps give the same layout."""
    jexp, pexp = exps[:2]
    qid = pexp.datasets["test"].entries[0]["question_id"]
    n = visualize.visualize_correct_ids(pexp, qid=qid,
                                        figures_root=str(tmp_path / "p"))
    monkeypatch.setattr(jvisualize, "attention_maps",
                        lambda *a, **kw: jax_maps)
    jvisualize.visualize_correct_ids(jexp, qid=qid,
                                     figures_root=str(tmp_path / "j"))
    cfg = pexp.model_cfg.t5
    assert n == cfg.num_decoder_layers * cfg.num_heads
    assert _figures(tmp_path / "p") == _figures(tmp_path / "j")
    assert len(_figures(tmp_path / "p")) == n
    entry = pexp.datasets["test"].get_question_by_id(qid)
    visualize.visualize_attn_weights(pexp, entry,
                                     attn_type="encoder_attentions",
                                     figures_root=str(tmp_path / "e"))
    assert _figures(tmp_path / "e") == _figures(tmp_path / "p")


def test_correct_ids_drive_the_figures(exps, tmp_path):
    """Without ``qid``: the ids of ``{log_root}/correct_ids.txt`` (the
    first ``limit``), an id not in the test split skipped."""
    pexp = exps[1]
    ids = [e["question_id"] for e in pexp.datasets["test"].entries[:2]]
    exp = copy.copy(pexp)
    exp.log_root = str(tmp_path / "logs")
    os.makedirs(exp.log_root)
    with open(os.path.join(exp.log_root, "correct_ids.txt"), "w") as f:
        f.write("\n".join(["no-such-id", *ids]) + "\n")
    n = visualize.visualize_correct_ids(exp, figures_root=str(tmp_path / "f"),
                                        limit=2)
    cfg = pexp.model_cfg.t5
    assert n == cfg.num_decoder_layers * cfg.num_heads
    assert os.listdir(tmp_path / "f") == [ids[0]]
    with pytest.raises(ValueError, match="not in the test set"):
        visualize.visualize_correct_ids(exp, qid="no-such-id")


def test_cli_eval_loads_the_checkpoint_and_writes_every_figure(
        exps, jax_maps, tmp_path, monkeypatch):
    """``main(["--eval", "--qid", ...])`` builds the experiment from the
    config, loads the checkpoint the JAX package wrote at its model path,
    and writes ``figures/<qid>/head<j>/attention<i>.pdf`` for every
    (layer, head) from maps equal to the JAX package's."""
    jexp, _, cfg, _ = exps
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    jckpt.save_checkpoint(os.path.join("models", jexp.model_prefix + ".npz"),
                          jexp.params)
    seen = []
    maps_of = visualize.attention_maps
    monkeypatch.setattr(visualize, "attention_maps",
                        lambda *a, **kw: seen.append(maps_of(*a, **kw))
                        or seen[-1])
    qid = jexp.dataset_test.entries[0]["question_id"]
    cli.main(["--eval", "--qid", qid, "--config", str(path), "--device",
              "cpu"])
    t5 = jexp.model_cfg.t5
    assert _figures("figures") == sorted(
        os.path.join(qid, f"head{j}", f"attention{i}.pdf")
        for i in range(t5.num_decoder_layers) for j in range(t5.num_heads))
    (got,) = seen
    np.testing.assert_array_equal(got["output_ids"], jax_maps["output_ids"])
    for k in MAPS:
        _close(got[k], jax_maps[k], k)


@pytest.mark.parametrize("skip_first", [0, 1, 3])
def test_step_timer_summary_matches_jax(skip_first):
    durations = [0.5, 0.12, 0.1, 0.3, 0.11, 0.2, 0.15]
    timers = (profiling.StepTimer(), jprofiling.StepTimer())
    for t in timers:
        t.durations = list(durations)
    got, want = (t.summary(skip_first) for t in timers)
    assert got == want and got["steps"] == len(durations) - skip_first
    with timers[0].step():
        pass
    assert len(timers[0].durations) == len(durations) + 1


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("mpr_region"):
            torch.ones(4).add_(1)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mpr_region" for e in events)


T5S = {"t5-small": "t5_small", "t5-large": "t5_large"}
T5_FNS = {
    "t5_encoder_flops": (4, 82),
    "t5_decoder_train_flops": (4, 8, 82),
    "t5_decode_prefill_flops": (4, 82),
    "t5_decode_step_flops": (4, 82, 20),
    "t5_greedy_decode_flops": (4, 82, 20, 7),
}
CLIP_FNS = {"vit_flops": (4,), "clip_text_flops": (4, 32)}
PLAIN_FNS = {"l2_topk_flops": (512, 1230, 1024),
             "projection_flops": (4, 50, 512, 1024)}


@pytest.mark.parametrize("fn,model", [(f, m) for f in T5_FNS for m in T5S]
                         + [(f, "ViT-B/32") for f in CLIP_FNS]
                         + [(f, None) for f in PLAIN_FNS])
def test_flops_equal_jax(fn, model):
    """Each function of ``ops/flops`` gives the JAX package's integer."""
    args = {**T5_FNS, **CLIP_FNS, **PLAIN_FNS}[fn]
    if fn in T5_FNS:
        cfgs = (getattr(pt5.T5Config, T5S[model])(),
                getattr(jt5.T5Config, T5S[model])())
    elif fn in CLIP_FNS:
        cfgs = (pclip.CLIPConfig.vit_b32(), jclip.CLIPConfig.vit_b32())
    else:
        cfgs = ((), ())
    cfgs = [c if isinstance(c, tuple) else (c,) for c in cfgs]
    got = getattr(pflops, fn)(*cfgs[0], *args)
    want = getattr(jflops, fn)(*cfgs[1], *args)
    assert isinstance(got, int) and got == want > 0
