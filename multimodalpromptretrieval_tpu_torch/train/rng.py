"""The dropout generator of the training loop.

Counterpart of ``multimodalpromptretrieval_tpu/train/rng.py``. Dropout bits
are not a parity surface (the torch reference draws them from the CUDA RNG,
the JAX package from a hardware RNG key): only the rate and the positions
where dropout is applied have to match. The port draws every mask of a run
from one seeded ``torch.Generator`` that lives on the tensors' device (a
CPU generator with a CUDA tensor raises), apart from the global RNG so that
initial parameters do not depend on it.
"""

from __future__ import annotations

import torch


def dropout_generator(seed: int, device) -> torch.Generator:
    """A seeded generator on ``device`` for ``ops.layers.dropout``."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
