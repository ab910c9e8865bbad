"""Passes over the test split: the closed loop of a group that scores a
model on a whole test set, or answers a day's studies in one batch.

A pass stages the split's images (``MPRServer.stage_images``), then submits
its questions as requests of ``request_rows`` rows, ``outstanding`` of them
in flight at most, on an ``MPRServer(pipeline_depth=...)``: how
``cli.serve_stream`` builds its server. Passes run back to back; a window
ends with the pass that crosses its length, so it holds only whole passes,
and the rate is every question of them over all of their time.

``driver_args`` of the workload file: ``request_rows``, ``outstanding``,
``pipeline_depth``.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import instrument, served


class Driver(served.ServedDriver):
    def setup(self) -> None:
        """Inputs, weights, the experiment and its server; then one pass,
        which builds every kernel and warms every shape the window uses."""
        (self.exp, self.server, self.splits,
         self.images) = served.build(self.config, self.workload, self.seed,
                                     self.device, self.quantize,
                                     self.setup_parts)
        tests = self.splits["test"]
        self.names = [e["image_name"] for e in tests]
        self.unique = list(dict.fromkeys(self.names))
        self.staged = np.stack([self.images[n] for n in self.unique])
        R = self.args["request_rows"]
        self.requests = [tests[s:s + R] for s in range(0, len(tests), R)]
        B = self.exp.batch_size
        self.chunk_rows: List[List[dict]] = []
        for req in self.requests:
            self.chunk_rows += [req[s:s + B] for s in range(0, len(req), B)]
        self.capture = instrument.Capture(
            keep=len(self.chunk_rows),
            select=served.sample_rows(self.chunk_rows,
                                      self.workload["check"]["decode_rows"],
                                      self.seed),
            vocab=self.config["t5"]["vocab_size"])
        with served.timed(self.setup_parts, "warm-up"):
            self.run(units=1)
            self._sync()

    def _pass(self, stats: Dict[str, float]) -> None:
        server = self.server
        server.stage_images(self.staged, self.unique)
        stats["images"] += len(self.unique)
        handles: collections.deque = collections.deque()

        def finish():
            req, handle = handles.popleft()
            try:
                answers = handle.result()
                if len(answers) != len(req):
                    raise RuntimeError("answers missing")
            except Exception:  # noqa: BLE001 (a failed request is counted)
                stats["failed"] += len(req)

        for req in self.requests:
            stats["attempted"] += len(req)
            try:
                handles.append((req, server.submit(
                    None, [e["question"] for e in req],
                    [e["task"] for e in req],
                    image_ids=[e["image_name"] for e in req])))
            except Exception:  # noqa: BLE001
                stats["failed"] += len(req)
                continue
            while len(handles) >= self.args["outstanding"]:
                finish()
        while handles:
            finish()
        stats["units"] += 1

    def run(self, seconds: Optional[float] = None,
            units: Optional[int] = None) -> Dict[str, float]:
        """Whole passes until ``seconds`` have passed or ``units`` passes
        are done, ending in a device sync."""
        stats = collections.defaultdict(float)
        steps0 = self.server.decode_steps
        ends: List[float] = []
        t0 = time.perf_counter()
        while True:
            self._pass(stats)
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if units is not None and stats["units"] >= units:
                break
            if seconds is not None and elapsed >= seconds:
                break
        self._sync()
        stats["seconds"] = time.perf_counter() - t0
        stats["answered"] = stats["attempted"] - stats["failed"]
        stats["decode_steps"] = self.server.decode_steps - steps0
        stats["unit_ends"] = ends
        return dict(stats)

    def flops(self, stats: Dict[str, float]) -> float:
        """Operations the inputs of ``stats``' passes need (every pass
        serves the same inputs, so the last pass's chunks stand for each)."""
        per_pass = served.staging_flops(self.config, len(self.unique))
        n_index = len(self.splits["train"])
        per_pass += sum(served.chunk_flops(self.config, rec, n_index)
                        for rec in self.capture.records)
        return per_pass * stats["units"]

    def chunks(self, stats: Dict[str, float]) -> float:
        return stats["units"] * len(self.chunk_rows)

    def check(self, control: bool = False):
        """(numbers, readings) of ``served.check`` over the last pass, once
        the program's state is freed, on the weights drawn again from the
        seed."""
        from portbench.weights import redraw

        records = list(self.capture.records)
        if len(records) != len(self.chunk_rows):
            raise RuntimeError(f"{len(records)} fused chunks captured of "
                               f"{len(self.chunk_rows)} a pass")
        self.capture.restore()
        self.close()
        pairs = [(rec, {"rows": rows})
                 for rec, rows in zip(records, self.chunk_rows)]
        weights = redraw(served.model_config(self.config), self.seed,
                         self.device)
        return served.check(self.config, self.workload, self.seed,
                            self.splits, self.images, weights, pairs,
                            self.device, control=control)
