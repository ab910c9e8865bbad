"""BENCHMARK.json, its files and the harness's lookups, on the CPU."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from portbench import run
from portbench.registry import HERE, ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_resolves(manifest):
    reg = Registry()
    for w in manifest["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert callable(reg.driver(cell["workload"]["driver"]))
        assert reg.metrics("end_to_end", w["name"])
        assert reg.metrics("per_layer", w["name"])
    for c in manifest["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for m in manifest["per_layer"]:
        assert callable(reg.reader(m["name"], "per_layer"))
    for m in manifest["end_to_end"]:
        assert callable(reg.reader(m["name"], "end_to_end"))


def test_manifest_keeps_the_contract(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in manifest[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in manifest["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_new_cell_is_only_a_file(tmp_path, manifest):
    """A throwaway cell: one workload file and one manifest entry, found by
    name with nothing else changed."""
    data = tmp_path / "data"
    shutil.copytree(os.path.join(HERE, "configs"), data / "configs")
    (data / "workloads").mkdir()
    with open(os.path.join(HERE, "workloads",
                           "t5-small.serve-pass.json")) as f:
        wl = json.load(f)
    wl["driver_args"]["request_rows"] = 256
    (data / "workloads" / "t5-small.serve-half.json").write_text(
        json.dumps(wl))
    m = dict(manifest)
    m["workloads"] = manifest["workloads"] + [{
        "name": "t5-small.serve-half", "config": "t5-small_vit-b32",
        "traffic": "serve-half", "chips": 1, "why": "half requests"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    reg = Registry(manifest=str(path), data=str(data))
    cell = reg.cell("t5-small.serve-half")
    assert cell["workload"]["driver_args"]["request_rows"] == 256
    assert reg.metrics("end_to_end", "t5-small.serve-half")


def test_import_check_compares_whole_names(monkeypatch):
    assert "multimodalpromptretrieval_tpu_torch" not in run.BANNED
    monkeypatch.setitem(sys.modules, "multimodalpromptretrieval_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    assert run.banned_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "multimodalpromptretrieval_tpu",
                        types.ModuleType("m"))
    assert run.banned_modules() == ["jax", "multimodalpromptretrieval_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.models, "
            "portbench.reference.text.spm, portbench.reference.text.clip_bpe;"
            " bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'multimodalpromptretrieval_tpu', "
            "'multimodalpromptretrieval_tpu_torch'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run exits with an error and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "t5-small.serve-pass", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
