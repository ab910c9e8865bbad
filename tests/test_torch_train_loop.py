"""The port's ``TrainingExperiment.train()`` against the JAX ``Experiment``.

One tiny synthetic SLAKE corpus on disk, one config (retrieval k=3, row
attention, dropout 0, fp32), one seeded JAX init bridged into the port; both
packages train two epochs on the CPU and then resume for one more from the
checkpoint the JAX package wrote. Per-epoch train and validation losses agree
within 1e-4; batch order, best epoch, hints and the vision-token table are the
same; the resumed run continues at the learning rate saved in the checkpoint.
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
from multimodalpromptretrieval_tpu.train import checkpoint as jckpt  # noqa: E402
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import (  # noqa: E402
    checkpoint as pckpt,
)
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)

TOL = 1e-4
SAVED_LR = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_losses(log_root, prefix, name):
    with open(os.path.join(log_root, prefix, name)) as f:
        rows = f.read().strip().splitlines()[1:]
    return [(int(r.split(",")[0]), float(r.split(",")[1])) for r in rows]


def _order(exp, make):
    return [[e["question_id"] for b in make(epoch) for e in b.entries]
            for epoch in (0, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_loop"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=12,
                             n_validate=4, n_test=4, image_size=32, seed=0)
    cfg = synthetic_config(root, batch_size=8, epochs=2, image_size=32,
                           retrieval=True, k=3)
    cfg["clip_overrides"].update(patch_size=16, attention_impl="row")
    cfg["t5_overrides"].update(attention_impl="row", dropout_rate=0.0)
    cfg["cache_retrieval"] = False
    out = {"root": root}
    jexp = Experiment(copy.deepcopy(cfg), train_mode=True, quiet=True,
                      log_root=os.path.join(root, "jax_logs"),
                      model_root=os.path.join(root, "jax_models"))
    splits = dict(train=jexp.dataset_train.entries,
                  validate=jexp.dataset_validate.entries,
                  test=jexp.dataset_test.entries, images=jexp.images)

    def port(params):
        return TrainingExperiment(
            copy.deepcopy(cfg), params=params, device="cpu", quiet=True,
            log_root=os.path.join(root, "port_logs"),
            model_root=os.path.join(root, "port_models"), **splits)

    probe = port(None)
    pexp = port(bridge.params_from_jax(jexp.params, probe.model_cfg))
    assert pexp.model_prefix == jexp.model_prefix

    out["jres"] = jexp.train()
    out["pres"] = pexp.train()
    out["jlosses"] = {n: _read_losses(jexp.log_root, jexp.model_prefix, n)
                      for n in ("training_loss.txt", "validation_loss.txt")}
    out["plosses"] = {n: _read_losses(pexp.log_root, pexp.model_prefix, n)
                      for n in ("training_loss.txt", "validation_loss.txt")}
    out["jorder"] = _order(jexp, lambda e: jexp.make_split_batches(
        jexp.dataset_train, "train", shuffle=True, epoch=e))
    out["porder"] = _order(pexp, lambda e: pexp.make_split_batches(
        "train", shuffle=True, epoch=e))
    out["hints"] = (jexp._hints, pexp._hints)
    out["tables"] = (np.asarray(jexp._vision_tokens[0]),
                     pexp._vision_tokens[0].numpy(),
                     jexp._vision_tokens[1], pexp._vision_tokens[1])
    out["n_train"] = len(splits["train"])

    # resume, both from the file the JAX package wrote, with its saved
    # learning rate changed so that a restart at the config's would show
    meta_path = jexp.model_path + ".json"
    with open(meta_path) as f:
        meta = json.load(f)
    out["saved_meta"] = dict(meta)
    meta["lr"] = SAVED_LR
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for exp in (jexp, pexp):
        exp.cfg["hyperparameters"]["epochs"] = 1
    pexp.model_path = os.path.join(root, "port_models", "resumed.npz")
    for suffix in ("", ".json"):
        with open(jexp.model_path + suffix, "rb") as src, \
                open(pexp.model_path + suffix, "wb") as dst:
            dst.write(src.read())
    out["jres2"] = jexp.train(resume=True)
    out["pres2"] = pexp.train(resume=True)
    out["resumed_lr"] = (jexp.scheduler.lr, pexp.scheduler.lr)
    out["jlosses2"] = {n: _read_losses(jexp.log_root, jexp.model_prefix, n)
                       for n in ("training_loss.txt", "validation_loss.txt")}
    out["exps"] = (jexp, pexp)
    return out


def test_batch_order_matches_jax(runs):
    assert runs["porder"] == runs["jorder"]
    assert runs["porder"][0] != runs["porder"][1]  # a fresh shuffle an epoch
    assert len(set(runs["porder"][0])) == runs["n_train"]


def test_hints_and_vision_table_match_jax(runs):
    jh, ph = runs["hints"]
    assert ph == jh and set(ph) == {"train", "validate"}
    assert all(h.startswith("I believe the answer is")
               for h in ph["train"].values())
    jt, pt, jrows, prows = runs["tables"]
    assert prows == jrows
    np.testing.assert_allclose(pt, jt, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["training_loss.txt",
                                  "validation_loss.txt"])
def test_epoch_losses_match_jax(runs, name):
    want, got = runs["jlosses"][name], runs["plosses"][name]
    assert len(got) == len(want) == 2
    assert [u for u, _ in got] == [u for u, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want],
                               atol=TOL, rtol=0)
    kind = "train_losses" if name.startswith("training") else "valid_losses"
    assert runs["pres"][kind] == got


def test_training_result_matches_jax(runs):
    jres, pres = runs["jres"], runs["pres"]
    assert pres["best_epoch"] == jres["best_epoch"]
    assert pres["parameter_updates"] == jres["parameter_updates"]
    np.testing.assert_allclose(pres["best_valid_loss"],
                               jres["best_valid_loss"], atol=TOL, rtol=0)
    train = [x for _, x in runs["plosses"]["training_loss.txt"]]
    assert train[1] < train[0]


def test_best_checkpoint_is_in_the_jax_format(runs):
    """The port's own best-validation checkpoint loads in the JAX package
    with the metadata of the epoch that wrote it."""
    jexp, pexp = runs["exps"]
    path = os.path.join(runs["root"], "port_models",
                        pexp.model_prefix + ".npz")
    params, opt, meta = jckpt.load_checkpoint(
        path, jexp.params, jexp.opt_state)
    assert meta["epoch"] == runs["pres"]["best_epoch"]
    assert meta["lr"] == 1e-3 and meta["config"]["k"] == 3
    np.testing.assert_allclose(meta["valid_loss"],
                               runs["saved_meta"]["valid_loss"], atol=TOL,
                               rtol=0)
    assert int(opt["step"]) == (meta["epoch"] + 1) * (
        runs["pres"]["parameter_updates"] // 2)
    port_params, _, _ = pckpt.load_checkpoint(path, pexp.model_cfg)
    np.testing.assert_array_equal(
        port_params.t5.shared.detach().numpy(), np.asarray(params["t5"]["shared"]))


def test_resume_continues_at_the_saved_lr(runs):
    jlr, plr = runs["resumed_lr"]
    assert jlr == plr == SAVED_LR
    jres, pres = runs["jres2"], runs["pres2"]
    assert pres["parameter_updates"] == jres["parameter_updates"]
    np.testing.assert_allclose(pres["best_valid_loss"],
                               jres["best_valid_loss"], atol=TOL, rtol=0)
    want = runs["jlosses2"]["training_loss.txt"]
    np.testing.assert_allclose([x for _, x in pres["train_losses"]],
                               [x for _, x in want], atol=TOL, rtol=0)


def test_resume_without_a_checkpoint_raises(runs):
    _, pexp = runs["exps"]
    path, pexp.model_path = pexp.model_path, os.path.join(
        runs["root"], "port_models", "missing.npz")
    try:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            pexp.train(resume=True)
    finally:
        pexp.model_path = path


def test_training_after_an_inference_mode_forward():
    """A forward in inference mode (a server's), then a training step's
    backward at the same sequence length in the same process, as one
    worker of the parallel test run does across files: the T5 position
    buckets, cached per shape, must not be inference tensors."""
    from multimodalpromptretrieval_tpu_torch.models import t5

    cfg = t5.T5Config.from_version("t5-small")
    table = torch.nn.Parameter(torch.randn(
        cfg.relative_attention_num_buckets, 4,
        generator=torch.Generator().manual_seed(0)))
    L = 43  # a length no other test of the file uses
    with torch.inference_mode():
        served = t5.compute_position_bias(table, L, L, bidirectional=True,
                                          cfg=cfg)
    bias = t5.compute_position_bias(table, L, L, bidirectional=True,
                                    cfg=cfg)
    bias.square().sum().backward()
    assert table.grad is not None and bool(table.grad.abs().sum() > 0)
    torch.testing.assert_close(bias.detach(), served, rtol=0, atol=0)
