"""Passes over the test split with the LM generator: ``serve_pass``'s
closed loop (its pass loop, by import) on an LM configuration
(``portbench/served_lm.py``): the weights drawn tensor by tensor and held
in bf16, the LM's logits and routing captured for the check, its spans
in the traced run, and its check.

``driver_args`` of the workload file: ``request_rows``, ``outstanding``,
``pipeline_depth``, as ``serve_pass``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench import served, served_lm
from portbench.drivers import serve_pass


class Driver(serve_pass.Driver):
    def setup(self) -> None:
        """Inputs, weights, the experiment and its server; then one pass,
        which builds every kernel and warms every shape the window uses."""
        if self.quantize is not None:
            raise ValueError("the LM cells serve in their compute dtype "
                             "only (no --quantize)")
        (self.exp, self.server, self.splits,
         self.images) = served_lm.build(self.config, self.workload,
                                        self.seed, self.device,
                                        self.setup_parts)
        tests = self.splits["test"]
        self.names = [e["image_name"] for e in tests]
        self.unique = list(dict.fromkeys(self.names))
        self.staged = np.stack([self.images[n] for n in self.unique])
        R = self.args["request_rows"]
        self.requests = [tests[s:s + R] for s in range(0, len(tests), R)]
        B = self.exp.batch_size
        self.chunk_rows = []
        for req in self.requests:
            self.chunk_rows += [req[s:s + B] for s in range(0, len(req), B)]
        self.capture = served_lm.Capture(
            keep=len(self.chunk_rows),
            select=served.sample_rows(self.chunk_rows,
                                      self.workload["check"]["decode_rows"],
                                      self.seed),
            vocab=self.config["vocab_size"])
        with served.timed(self.setup_parts, "warm-up"):
            self.run(units=1)
            self._sync()

    def spans(self, cuda: bool):
        return served_lm.Spans(self.exp)

    def flops(self, stats: Dict[str, float]) -> float:
        per_pass = served_lm.staging_flops(self.config, len(self.unique))
        n_index = len(self.splits["train"])
        per_pass += sum(served_lm.chunk_flops(self.config, rec, n_index)
                        for rec in self.capture.records)
        return per_pass * stats["units"]

    def check(self, control: bool = False):
        """(numbers, readings) of ``served_lm.check`` over the last pass,
        once the program's state is freed, on the weights drawn again from
        the seed."""
        from portbench.weights_lm import Redraw

        records = list(self.capture.records)
        if len(records) != len(self.chunk_rows):
            raise RuntimeError(f"{len(records)} fused chunks captured of "
                               f"{len(self.chunk_rows)} a pass")
        self.capture.restore()
        self.close()
        pairs = [(rec, {"rows": rows})
                 for rec, rows in zip(records, self.chunk_rows)]
        weights = Redraw(served_lm.model_config(self.config), self.seed,
                         self.device)
        return served_lm.check(self.config, self.workload, self.seed,
                               self.splits, self.images, weights, pairs,
                               self.device, control=control)
