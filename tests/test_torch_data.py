"""The port's data path against the JAX package, on the CPU.

Image preprocessing (``ops/image.py``), the image cache (``data/
images.py``), the dataset parsers and filters (``data/datasets.py``,
``serving.load_filtered_triple``), the retrieval index's file format,
``extend`` and return modes (``retrieval/index.py``) and the test metrics
(``train/metrics.py``): the same seeded inputs through both packages give
the same arrays (images within 2e-5 after normalization), the same entries,
labels, ranks, report text and artifact files.
"""

import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from multimodalpromptretrieval_tpu.data import datasets as jdatasets  # noqa: E402
from multimodalpromptretrieval_tpu.data import images as jimages  # noqa: E402
from multimodalpromptretrieval_tpu.data.synthetic import (  # noqa: E402
    generate_synthetic_slake,
    generate_synthetic_vqarad,
)
from multimodalpromptretrieval_tpu.ops import image as jimage  # noqa: E402
from multimodalpromptretrieval_tpu.retrieval import index as jindex  # noqa: E402
from multimodalpromptretrieval_tpu.train import experiment as jexperiment  # noqa: E402
from multimodalpromptretrieval_tpu.train import metrics as jmetrics  # noqa: E402
from multimodalpromptretrieval_tpu_torch import serving as pserving  # noqa: E402
from multimodalpromptretrieval_tpu_torch.data import datasets as pdatasets  # noqa: E402
from multimodalpromptretrieval_tpu_torch.data import images as pimages  # noqa: E402
from multimodalpromptretrieval_tpu_torch.ops import image as pimage  # noqa: E402
from multimodalpromptretrieval_tpu_torch.retrieval import index as pindex  # noqa: E402
from multimodalpromptretrieval_tpu_torch.train import metrics as pmetrics  # noqa: E402

IMAGE_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers; with the cores oversubscribed,
    torch's OpenMP pool makes these tiny ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A synthetic SLAKE (32-px images) and VQA-RAD on disk."""
    root = str(tmp_path_factory.mktemp("torch_data"))
    generate_synthetic_slake(os.path.join(root, "SLAKE"), n_train=24,
                             n_validate=6, n_test=6, image_size=32, seed=3)
    generate_synthetic_vqarad(os.path.join(root, "VQA_RAD"), n_train=8,
                              n_test=4, image_size=32, seed=4)
    return root


# ---------------------------------------------------------------------------
# ops/image.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((2, 48, 32, 3), 32),    # portrait, downsampled
    ((2, 32, 48, 3), 32),    # landscape
    ((3, 32, 32, 3), 32),    # same size: normalization only
    ((1, 70, 96, 3), 48),    # 48 * 96 / 70 = 65.8: the long side truncated
    ((2, 20, 26, 3), 32),    # upsampled
])
def test_clip_preprocess_matches_jax(shape, size):
    rng = np.random.default_rng(sum(shape) + size)
    x = rng.integers(0, 256, size=shape).astype(np.uint8)
    want = np.asarray(jimage.clip_preprocess(jnp.asarray(x), size=size))
    got = pimage.clip_preprocess(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == (shape[0], 3, size, size)
    np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)


def test_preprocess_pil_images_order_grouping_and_grayscale():
    """Mixed sizes and modes (a grayscale and a palette image among RGB
    ones): every output in input order, equal to the JAX function's."""
    rng = np.random.default_rng(9)
    ims = []
    for h, w, mode in ((40, 30, "RGB"), (32, 32, "L"), (40, 30, "RGB"),
                       (24, 36, "RGB"), (32, 32, "RGB"), (40, 30, "P")):
        arr = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
        im = Image.fromarray(arr)
        ims.append(im.convert(mode) if mode != "RGB" else im)
    want = jimage.preprocess_pil_images(ims, size=32, batch=2)
    got = pimage.preprocess_pil_images(ims, size=32, batch=2)
    assert len(got) == len(want) == len(ims)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=IMAGE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# data/datasets.py and the filters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg", [
    ("SLAKE", {"train_subset": 0.5, "max_answers": 6}),
    ("SLAKE", {"fewshot_training_tasks": {
        "enabled": True, "tasks": ["Shape", "Color"],
        "examples_per_task": 5}, "max_answers": 8}),
    ("VQA_RAD", {}),
])
def test_filtered_triple_and_labels_match_jax(data_root, name, cfg):
    """The reference's filter order (fewshot, train_subset, max_answers),
    the VQA-RAD validate -> train alias and comma fan-out: identical
    entries in order, and identical label maps."""
    want = jexperiment.load_filtered_triple(cfg, data_root, name)
    got = pserving.load_filtered_triple(cfg, data_root, name)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert g.entries == w.entries and len(g.entries) > 0
    assert pdatasets.create_ans2label(*got) == \
        jdatasets.create_ans2label(*want)
    assert got[0].summary() == want[0].summary()


def test_closest_label_and_stratified_split_match_jax(data_root):
    jds = jdatasets.load_dataset(data_root, "SLAKE", "test")
    pds = pdatasets.load_dataset(data_root, "SLAKE", "test")
    _, ans2label = jdatasets.create_ans2label(jds)
    jds.add_labels(ans2label)
    pds.add_labels(ans2label)
    for answer in ("circle", "squre", "blu", "", "no", "crosses"):
        assert pds.get_closest_label(answer) == jds.get_closest_label(answer)
    assert pds.get_stratified_split(0.3, seed=5) == \
        jds.get_stratified_split(0.3, seed=5)
    assert pds.get_question_by_id("3") == jds.get_question_by_id("3")


# ---------------------------------------------------------------------------
# data/images.py
# ---------------------------------------------------------------------------


def test_image_cache_matches_jax_and_files_cross_load(data_root, tmp_path,
                                                      monkeypatch):
    root = os.path.join(data_root, "SLAKE")
    entries = jdatasets.load_dataset(data_root, "SLAKE", "validate").entries
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jimages.ImageCache.build(root, entries, "validate", size=32,
                                    cache_dir=jdir)
    got = pimages.ImageCache.build(root, entries, "validate", size=32,
                                   cache_dir=pdir, device="cpu")
    names = list(dict.fromkeys(e["image_name"] for e in entries))
    assert list(got.arrays) == list(want.arrays) == names
    np.testing.assert_allclose(got.batch(names), want.batch(names),
                               atol=IMAGE_TOL, rtol=0)
    # a file written by one package loads in the other; the port's with
    # PIL blocked (a complete cache decodes nothing; the JAX package
    # imports PIL in any case)
    from_port = jimages.ImageCache.build(root, entries, "validate", size=32,
                                         cache_dir=pdir)
    np.testing.assert_array_equal(from_port.batch(names), got.batch(names))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    from_jax = pimages.ImageCache.build(root, entries, "validate", size=32,
                                        cache_dir=jdir)
    np.testing.assert_array_equal(from_jax.batch(names), want.batch(names))
    with pytest.raises(ImportError):  # a missing name needs PIL
        pimages.ImageCache.build(root, entries, "validate", size=48,
                                 cache_dir=jdir)


def test_shared_caches_appear_only_whole(data_root, tmp_path, monkeypatch):
    """The image cache and the retrieval index cache, which the processes
    of a group build together, are written to a file of the writer's own
    and renamed into place (a process that reads the cache's path never
    finds it half written); no temp file stays."""
    written = []
    savez = np.savez_compressed

    def watch(f, **arrays):
        name = os.path.abspath(getattr(f, "name", f))
        written.append(os.path.splitext(name)[0]
                       == os.path.splitext(watch.target)[0])
        return savez(f, **arrays)

    monkeypatch.setattr(np, "savez_compressed", watch)
    root = os.path.join(data_root, "SLAKE")
    entries = pdatasets.load_dataset(data_root, "SLAKE", "validate").entries
    watch.target = os.path.join(str(tmp_path), "images_validate_32.npz")
    pimages.ImageCache.build(root, entries, "validate", size=32,
                             cache_dir=str(tmp_path), device="cpu")
    emb, answers, info = _corpus(0, 5)
    index = pindex.RetrievalIndex(torch.from_numpy(emb), answers, info)
    watch.target = os.path.join(str(tmp_path), "index.npz")
    index.save(os.path.join(str(tmp_path), "index"))
    assert written == [False, False]
    assert sorted(os.listdir(tmp_path)) == ["images_validate_32.npz",
                                            "index.npz"]
    assert len(pindex.RetrievalIndex.load(watch.target).answers) == 5


# ---------------------------------------------------------------------------
# retrieval/index.py
# ---------------------------------------------------------------------------


def _corpus(seed, n, offset=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, 16)).astype(np.float32)
    answers = [f"a{int(x)}" for x in rng.integers(0, 4, size=n)]
    info = {"question_type": [["open", "closed"][i % 2] for i in range(n)],
            "question_id": [str(offset + i) for i in range(n)],
            "question": [f"q{offset + i}" for i in range(n)]}
    return emb, answers, info


def test_retrieval_index_modes_files_and_extend_match_jax(tmp_path):
    emb, answers, info = _corpus(1, 40)
    extra = _corpus(2, 12, offset=40)
    query = np.random.default_rng(3).normal(size=(9, 16)).astype(np.float32)
    query[0] = emb[5]  # its own nearest neighbour
    jidx = jindex.RetrievalIndex(emb, answers, dict(info), retrieval_k=4)
    pidx = pindex.RetrievalIndex(emb, answers, dict(info), retrieval_k=4,
                                 device="cpu")
    # files cross both ways, then extend by a second corpus
    jidx.save(str(tmp_path / "j" / "index.npz"))
    pidx.save(str(tmp_path / "p" / "index.npz"))
    jidx = jindex.RetrievalIndex.load(str(tmp_path / "p" / "index.npz"),
                                      retrieval_k=4)
    pidx = pindex.RetrievalIndex.load(str(tmp_path / "j" / "index.npz"),
                                      retrieval_k=4)
    jidx.extend(jindex.RetrievalIndex(*extra))
    pidx.extend(pindex.RetrievalIndex(*extra))
    np.testing.assert_array_equal(pidx.embeddings.numpy(),
                                  np.asarray(jidx.embeddings))
    assert pidx.answers == jidx.answers
    assert pidx.question_info == jidx.question_info
    q = torch.from_numpy(query)
    for phase in (True, False):
        jidx.is_training_phase = pidx.is_training_phase = phase
        jd, ji = jidx.topk(jnp.asarray(query), 7)
        pd, pi = pidx.topk(q, 7)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-5,
                                   rtol=0)
        for kw in (dict(return_ans=True),
                   dict(return_info=["question_id", "question_type"]),
                   dict(), dict(use_quantifier=False, k=3)):
            assert pidx.retrieve(q, **kw) == jidx.retrieve(
                jnp.asarray(query), **kw)
        pairs = pidx.retrieve(q, return_dists=True)
        want = jidx.retrieve(jnp.asarray(query), return_dists=True)
        assert [a for a, _ in pairs] == [a for a, _ in want]
        np.testing.assert_allclose(np.stack([d for _, d in pairs]),
                                   np.stack([d for _, d in want]),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="question_info keys differ"):
        pidx.extend(pindex.RetrievalIndex(emb[:2], answers[:2],
                                          {"question": ["x", "y"]}))


def test_retrieval_index_build_order_and_cache_match_jax(tmp_path):
    """``build`` with a permutation writes the JAX file format; a second
    build reads it back instead of embedding."""
    emb, answers, info = _corpus(4, 10)
    entries = [{"image_name": f"im{i}", "answer": answers[i],
                "question_type": info["question_type"][i],
                "question_id": info["question_id"][i],
                "question": info["question"][i]} for i in range(10)]
    rows = {f"im{i}": i for i in range(10)}
    order = list(np.random.default_rng(5).permutation(10))
    calls = []

    def embed(images, text_ids):
        calls.append(len(images))
        return emb[np.asarray(images)]

    kw = dict(image_batch_fn=lambda names: np.asarray(
        [rows[n] for n in names]), clip_tokenize=lambda qs: np.zeros(
            (len(qs), 4), np.int32), batch_size=4, order=order)
    path = str(tmp_path / "cache" / "index.npz")
    want = jindex.RetrievalIndex.build(embed, entries, **kw)
    got = pindex.RetrievalIndex.build(
        lambda *a: torch.from_numpy(embed(*a)), entries, cache_path=path,
        device="cpu", **kw)
    assert calls == [4, 4, 2, 4, 4, 2]
    np.testing.assert_array_equal(got.embeddings.numpy(),
                                  np.asarray(want.embeddings))
    assert got.answers == want.answers
    assert got.question_info == want.question_info
    again = pindex.RetrievalIndex.build(None, entries, cache_path=path,
                                        device="cpu", **kw)
    assert len(calls) == 6  # read from the file, nothing embedded
    assert again.question_info == want.question_info
    np.testing.assert_array_equal(
        np.asarray(jindex.RetrievalIndex.load(path).embeddings),
        np.asarray(want.embeddings))


# ---------------------------------------------------------------------------
# train/metrics.py
# ---------------------------------------------------------------------------


def _feed(metrics_cls, seed):
    rng = np.random.default_rng(seed)
    tasks = ["Shape", "Color", "Presence", "Organ"]
    m = metrics_cls(retrieval_k=3)
    pool = ["circle", "square", "red", "yes", "no", "blue"]
    for i in range(40):
        gt = pool[int(rng.integers(0, 6))]
        pred = gt if rng.random() < 0.5 else pool[int(rng.integers(0, 6))]
        entry = {"question_id": str(i), "task": tasks[i % 4],
                 "question_type": ["open", "closed"][i % 3 == 0],
                 "answer": gt, "label": pool.index(gt)}
        closest = (pool.index(pred) if rng.random() < 0.8 else None)
        m.add_generative(pred.upper() if i % 7 == 0 else pred, entry,
                         closest)
        ra = [pool[int(x)] for x in rng.integers(0, 6, size=3)]
        m.add_retrieval_diagnostics(pred, entry, ra, [
            ["open", "closed"][int(x)] for x in rng.integers(0, 2, 3)])
    return m


def test_test_metrics_report_and_files_match_jax(tmp_path):
    want, got = _feed(jmetrics.TestMetrics, 6), _feed(pmetrics.TestMetrics, 6)
    assert got.report() == want.report()
    assert got.predictions == want.predictions
    want.write_artifacts(str(tmp_path / "jax"), "model_x")
    got.write_artifacts(str(tmp_path / "port"), "model_x")
    for name in ("incorrect_ids.txt", "correct_ids.txt",
                 "model_xperformance.txt"):
        with open(tmp_path / "jax" / name) as a, \
                open(tmp_path / "port" / name) as b:
            assert b.read() == a.read()


@pytest.mark.parametrize("ra,gt", [(["b", "a"], "a"), (["a", "b"], "a"),
                                   (["b", "a", "a"], "a"),
                                   (["c", "b", "b", "a", "a"], "b")])
def test_tied_retrieval_vote_matches_jax(ra, gt):
    """The JAX cases of the diagnostics' tie rule (first retrieval rank),
    replayed through both packages."""
    out = []
    for cls in (jmetrics.TestMetrics, pmetrics.TestMetrics):
        m = cls(retrieval_k=len(ra))
        m.add_retrieval_diagnostics("x", {"answer": gt, "question_type":
                                          "qt"}, ra, ["qt"] * len(ra))
        out.append((m.full_retrieval_reliance_gt, m.report()))
    assert out[0] == out[1]
    assert out[1][0] == int(pindex.majority_vote(ra)[0] == gt)
