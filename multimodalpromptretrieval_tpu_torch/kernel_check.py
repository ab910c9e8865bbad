"""On-card check of the two attention kernels that no model path calls.

    python3 -m multimodalpromptretrieval_tpu_torch.kernel_check

Counterpart of the ``row_attention`` and ``short_attention`` cases of the
JAX package's ``scripts/tpu_kernel_check.py``, at its shapes: K5
(``ops/row_attention.row_attention``) and K9
(``ops/short_attention.short_attention``) in bf16 against the head-layout
``ops/attention.attention_xla``, an oracle that shares no code with their
own plain versions. Nothing in either package's models calls these two
kernels; this check and the tests are their users. The kernels of the model
paths are checked where they run (``chip_smoke.py``).

Prints one PASS / FAIL line per kernel; exits non-zero on a failure or
without a CUDA device.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import torch

from multimodalpromptretrieval_tpu_torch.ops.attention import attention_xla
from multimodalpromptretrieval_tpu_torch.ops.row_attention import (
    row_attention,
)
from multimodalpromptretrieval_tpu_torch.ops.short_attention import (
    short_attention,
)
from multimodalpromptretrieval_tpu_torch.serving import resolve_device


@torch.no_grad()
def run(device=None, seed: int = 0) -> List[Tuple[str, bool, float]]:
    """[(name, ok, max abs difference)] on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)

    results = []
    # K9: ViT-like heads, L = 50 (not a multiple of 8)
    qs = randn(4, 12, 50, 64)
    want = attention_xla(qs, qs, qs, scale=64 ** -0.5).float()
    got = short_attention(qs, qs, qs, scale=64 ** -0.5).float()
    d = (want - got).abs().max().item()
    results.append(("short_attention[packed]", d < 5e-2, d))
    # K5: separately allocated q, k, v rows
    B, L, H, Dh = 4, 64, 8, 64
    q, k, v = (randn(B, L, H * Dh) for _ in range(3))

    def to_h(t):
        return t.reshape(B, L, H, Dh).transpose(1, 2)

    want = attention_xla(to_h(q), to_h(k), to_h(v), scale=Dh ** -0.5).float()
    got = to_h(row_attention(q, k, v, heads=H, scale=Dh ** -0.5)).float()
    d = (want - got).abs().max().item()
    results.append(("row_attention", d < 5e-2, d))
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_check: no CUDA device", file=sys.stderr)
        return 1
    results = run()
    for name, ok, d in results:
        print(f"{'PASS' if ok else 'FAIL'} {name} maxdiff={d:.4f}")
    return 0 if all(ok for _, ok, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
