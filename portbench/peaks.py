"""The card's published peaks and the least time a piece of work can take.

A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``,
``bound`` and ``nbytes``: NVIDIA's data sheet of the H100 SXM, dense rates
without sparsity, at its 700 W power limit. A card set below 700 W runs
slower under load, so every share of these peaks is printed beside the
card's ``power.limit``.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
              "float32": 67e12}


def bound(nbytes: float, flops: float, peak: float) -> Tuple[float, str]:
    """(least seconds, which bound holds): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def card() -> Tuple[str, str]:
    """(name, power limit) as ``nvidia-smi`` reads them; "not read" where
    it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        name, limit = (s.strip() for s in out[0].split(",", 1))
        return name, limit
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return "not read", "not read"
