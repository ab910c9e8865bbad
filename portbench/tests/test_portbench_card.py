"""The checks' controls at the cells' own sizes, on the card.

Each cell runs a short window with its control in the program's place:
the reference computed with fp8 products, and the program's own int8
path. Each has to come out of the run as not correct, while the program's
own numbers, read in the same run as the fp8 control, pass the cell's
limits. Run on the card with
``python -m pytest -m cuda portbench/tests``.
"""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.registry import Registry

SERVED = ("t5-small.serve-pass", "t5-large.serve-pass")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _passes(limits: dict, numbers: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVED)
def test_served_controls_fail(cell):
    device = _card()
    reg = Registry()
    limits = reg.cell(cell)["workload"]["check"]["limits"]
    out = run.run_cell(reg, cell, 2 ** 31 + 101, 5.0, False, device,
                       control=True)
    assert out["correct"] is False, out["checks"]
    assert _passes(limits, out["_ctx"]["readings"]["program"])
    int8 = run.run_cell(reg, cell, 2 ** 31 + 101, 5.0, False, device,
                        quantize="int8_all")
    assert int8["correct"] is False, int8["checks"]

