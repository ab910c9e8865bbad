"""Everything the harness runs, found by name.

``BENCHMARK.json`` (the repository's root) names the cells and metrics; the
files of each sit beside this module:

* ``configs/<config>.json``: a model configuration as it is run;
* ``workloads/<cell>.json``: a cell: its configuration, its driver, the
  driver's arguments, its traffic parameters and its check;
* ``drivers/<driver>.py``: a ``Driver`` class that runs a kind of traffic;
* ``layer_metrics/<metric>.py``: a ``read(ctx)`` that takes one per-layer
  metric from the traced run, or returns None where it finds nothing;
* ``end_to_end/<metric>.py``: the same for an end-to-end metric, from the
  untraced run.

A later cell, configuration, driver or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(path: str):
    """A module of the harness's files by its path (their names hold dots
    and dashes, so they are not importable by name)."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """``manifest``: the ``BENCHMARK.json`` to read; ``data``: the folder
    of the configuration and workload files (the harness's own by
    default)."""

    def __init__(self, manifest: str = os.path.join(ROOT, "BENCHMARK.json"),
                 data: str = HERE):
        with open(manifest) as f:
            self.manifest = json.load(f)
        self.data = data

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.data, kind, name + ".json")) as f:
            return json.load(f)

    def _module(self, kind: str, name: str):
        return load(os.path.join(HERE, kind, name + ".py"))

    def cell(self, name: str) -> dict:
        """The manifest's entry of a cell, with its workload file under
        ``"workload"`` and its configuration file under ``"config_file"``."""
        entry = next((w for w in self.manifest["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        workload = self._json("workloads", name)
        if workload["config"] != entry["config"]:
            raise ValueError(f"{name}: the workload file's config "
                             f"{workload['config']!r} is not the manifest's")
        return dict(entry, workload=workload,
                    config_file=self._json("configs", entry["config"]))

    def driver(self, name: str):
        return self._module("drivers", name).Driver

    def reader(self, metric: str, kind: str = "per_layer"):
        """The ``read(ctx)`` of a metric: ``layer_metrics/<metric>.py`` for
        a per-layer metric, ``end_to_end/<metric>.py`` for an end-to-end
        one."""
        folder = "layer_metrics" if kind == "per_layer" else "end_to_end"
        return self._module(folder, metric).read

    def metrics(self, kind: str, cell: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.manifest[kind]
                if cell in m.get("workloads", [cell])]
