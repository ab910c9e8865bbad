"""Three config keys of the port against the JAX package's rules, on the
CPU: ``transfer_dataset`` (zero-shot transfer, the JAX
``tests/test_transfer.py::test_zero_shot_transfer_flow``),
``further_finetune`` (the resume's new save path and learning-rate reset)
and ``retrieval_cache_compat`` (the retrieval cache keyed by the dataset
class alone).

Transfer: the JAX ``Experiment`` trains one epoch on synthetic SLAKE; the
port's experiment, built with the JAX init (the retrieval index keeps the
CLIP it was built with), tests the JAX checkpoint on synthetic VQA-RAD with
a VQA-RAD retrieval corpus: the data swapped only when not training, the
training tokenizer, and the JAX test's predictions and scores.
"""

import copy
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from multimodalpromptretrieval_tpu.data import datasets as jdatasets  # noqa: E402
from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    generate_synthetic_vqarad,
    synthetic_config,
)
from multimodalpromptretrieval_tpu.train.experiment import Experiment  # noqa: E402
from multimodalpromptretrieval_tpu_torch import bridge  # noqa: E402
from multimodalpromptretrieval_tpu_torch.serving import (  # noqa: E402
    ServingExperiment,
)
from multimodalpromptretrieval_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train.experiment import (  # noqa: E402
    TrainingExperiment,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_config_keys"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=16,
                             n_validate=8, n_test=8, image_size=32, seed=0)
    generate_synthetic_vqarad(os.path.join(root, "VQA_RAD"), n_train=12,
                              n_test=8, image_size=32, seed=1)
    return root


def _cfg(root, **kw):
    """The JAX transfer test's configuration (one epoch, B = 8, 32 px),
    on one JAX device."""
    cfg = synthetic_config(root, batch_size=8, epochs=1, image_size=32)
    cfg["clip_overrides"].update(image_resolution=32, patch_size=16)
    cfg["parallelism"] = {"data": 1}
    cfg.update(kw)
    return cfg


def _model_cfg(cfg, train_mode):
    return ServingExperiment(dict(cfg, retrieval=0), device="cpu",
                             train_mode=train_mode).model_cfg


@pytest.fixture(scope="module")
def transfer(root, tmp_path_factory):
    """The JAX flow of ``test_zero_shot_transfer_flow``, and the port's
    test-mode experiment on the JAX init testing the JAX checkpoint."""
    cfg = _cfg(root, transfer_dataset="VQA_RAD", retrieval=1,
               retrieval_dataset="VQA_RAD", k=2, cache_retrieval=False)
    out = str(tmp_path_factory.mktemp("transfer"))
    paths = dict(log_root=os.path.join(out, "jax_logs"),
                 model_root=os.path.join(out, "models"))
    jexp = Experiment(copy.deepcopy(cfg), train_mode=True, quiet=True,
                      **paths)
    jexp.train()
    jexp2 = Experiment(copy.deepcopy(cfg), train_mode=False, quiet=True,
                       **paths)
    jmetrics = jexp2.test()
    params = bridge.params_from_jax(jexp2.params, _model_cfg(cfg, False))
    pexp = TrainingExperiment(copy.deepcopy(cfg), train_mode=False,
                              params=params, device="cpu", quiet=True,
                              log_root=os.path.join(out, "port_logs"),
                              model_root=paths["model_root"])
    return dict(cfg=cfg, jexp=jexp, jexp2=jexp2, jmetrics=jmetrics,
                pexp=pexp, metrics=pexp.test())


def test_transfer_swaps_the_data_only_when_not_training(root, transfer):
    """Training reads the source dataset, testing the transfer dataset
    with the VQA-RAD retrieval corpus; the test split and the index are
    the JAX experiment's."""
    cfg, pexp, jexp2 = transfer["cfg"], transfer["pexp"], transfer["jexp2"]
    trainer = ServingExperiment(dict(cfg, retrieval=0), device="cpu",
                                train_mode=True)
    assert trainer.data_name == "SLAKE"
    assert pexp.data_name == jexp2.data_name == "VQA_RAD"
    assert type(pexp.retrieval_dataset).__name__ == "VQARADDataset"
    assert pexp.splits["test"] == jexp2.dataset_test.entries
    assert pexp.label2ans == jexp2.label2ans
    assert pexp.retrieval_index.answers == jexp2.retrieval_index.answers
    np.testing.assert_allclose(
        pexp.retrieval_index.embeddings.numpy(),
        np.asarray(jexp2.retrieval_index.embeddings), atol=1e-5, rtol=0)


def test_transfer_keeps_the_training_tokenizer(transfer):
    """The tokenizer is the one the checkpoint was trained with (built from
    the SOURCE dataset), not one rebuilt from the transfer dataset."""
    pexp, jexp = transfer["pexp"], transfer["jexp"]
    assert pexp.tokenizer.vocab.pieces == jexp.tokenizer.vocab.pieces
    for e in pexp.splits["test"]:
        assert pexp.tokenizer.encode(e["question"]) == \
            jexp.tokenizer.encode(e["question"])


def test_transfer_test_matches_jax(transfer):
    """``test()`` of the JAX checkpoint on the transfer split: the JAX
    test's predictions, per-task totals and scores."""
    got, want = transfer["metrics"], transfer["jmetrics"]
    assert sum(got.total.values()) == len(transfer["pexp"].splits["test"])
    assert got.predictions == want.predictions
    assert got.total == want.total
    assert got.report() == want.report()


def _trained(root, out, lr_saved):
    """A one-process experiment (seeded weights, 1 epoch, lr 1e-3) whose
    checkpoint at its ``model_path`` records ``lr_saved`` as its decayed
    learning rate."""
    cfg = _cfg(root, t5_overrides=dict(_cfg(root)["t5_overrides"],
                                       dropout_rate=0.0))
    cfg["hyperparameters"]["learning_rate"] = 1e-3
    exp = TrainingExperiment(copy.deepcopy(cfg), device="cpu", quiet=True,
                             log_root=os.path.join(out, "logs"),
                             model_root=os.path.join(out, "models"))
    ckpt.save_checkpoint(exp.model_path, exp.params, exp.model_cfg,
                         exp.opt_state, metadata={"epoch": 0, "lr": lr_saved,
                                                  "valid_loss": 1.0})
    return cfg, exp


@pytest.mark.parametrize("further", [False, True])
def test_further_finetune_resets_the_lr_and_saves_apart(root, tmp_path,
                                                        further):
    """``--resume``: without ``further_finetune`` the run continues at the
    checkpoint's decayed learning rate and re-saves its file; with it the
    learning rate is the config's again and the checkpoint goes to
    ``{prefix}_msrc_with_retrieval_80.npz`` beside the untouched original
    (the JAX ``Experiment.train`` rule)."""
    cfg, first = _trained(root, str(tmp_path), lr_saved=2.5e-4)
    original = first.model_path
    before = os.path.getmtime(original), os.path.getsize(original)
    cfg["further_finetune"] = further
    exp = TrainingExperiment(copy.deepcopy(cfg), device="cpu", quiet=True,
                             log_root=os.path.join(str(tmp_path), "logs"),
                             model_root=os.path.join(str(tmp_path), "models"))
    exp.train(resume=True)
    saved = os.path.join(str(tmp_path), "models",
                         exp.model_prefix + "_msrc_with_retrieval_80.npz")
    if further:
        assert exp.scheduler.lr == 1e-3
        assert exp.model_path == saved and os.path.exists(saved)
        assert (os.path.getmtime(original),
                os.path.getsize(original)) == before
    else:
        assert exp.scheduler.lr == 2.5e-4
        assert exp.model_path == original and not os.path.exists(saved)
        _, _, meta = ckpt.load_checkpoint(original, exp.model_cfg)
        assert meta["epoch"] == 0 and meta["lr"] == 2.5e-4
        assert meta["valid_loss"] != 1.0  # written by the resumed run


@pytest.mark.parametrize("compat", [True, False])
def test_retrieval_cache_compat_keys_by_the_class_alone(root, tmp_path,
                                                        compat):
    """``retrieval_cache_compat``: the index file under the dataset class's
    name (the JAX package's key, quirk #4), read back by an experiment of
    another seed although its CLIP differs; without it the content key
    names the seed, and each experiment embeds its own index."""
    cfg = _cfg(root, retrieval=1, k=2, retrieval_cache_compat=compat,
               retrieval_cache_dir=str(tmp_path / "cache"))
    first = ServingExperiment(copy.deepcopy(cfg), device="cpu")
    second = ServingExperiment(dict(copy.deepcopy(cfg), seed=7),
                               device="cpu")
    name = type(jdatasets.load_dataset(root, "SLAKE", "train")).__name__
    assert type(first.retrieval_dataset).__name__ == name
    dirs = sorted(os.listdir(tmp_path / "cache"))
    same = torch.equal(first.retrieval_index.embeddings,
                       second.retrieval_index.embeddings)
    if compat:
        assert dirs == [name]
        assert os.path.exists(tmp_path / "cache" / name / "index.npz")
        assert same
    else:
        assert len(dirs) == 2 and all(d.startswith(name + "-") for d in dirs)
        assert not same
    assert json.dumps(first.retrieval_index.answers) == json.dumps(
        second.retrieval_index.answers)


def test_prefix_cache_matches_direct_path(root, tmp_path, monkeypatch):
    """``cache_image_prefix`` (the JAX ``tests/test_integration.py`` test of
    the same name): ``test()`` with the visual prefixes staged once per
    image and with the vision tower run on every batch gives the same
    answers; with the key off the staging is never reached."""
    cfg = _cfg(root)
    paths = dict(log_root=os.path.join(str(tmp_path), "logs"),
                 model_root=os.path.join(str(tmp_path), "models"))
    on = TrainingExperiment(copy.deepcopy(cfg), train_mode=False,
                            device="cpu", quiet=True, **paths)
    m1 = on.test(load=False)

    def refuse(self, entries):
        raise AssertionError("cache_image_prefix is off: no prefix staging")

    monkeypatch.setattr(TrainingExperiment, "stage_image_prefixes", refuse)
    off = TrainingExperiment(dict(copy.deepcopy(cfg),
                                  cache_image_prefix=False),
                             train_mode=False, params=on.params,
                             device="cpu", quiet=True, **paths)
    m2 = off.test(load=False)
    assert sum(m1.total.values()) == len(on.splits["test"])
    assert m1.correct_ids == m2.correct_ids
    assert m1.incorrect_ids == m2.incorrect_ids
    assert m1.overall == m2.overall
