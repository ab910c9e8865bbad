"""Random weights of the LM configurations, drawn tensor by tensor from
(seed, name).

The program gets an :class:`MPRGen` whose LM is held in the compute dtype
only (bf16: the 16 B-parameter model in fp32 and a bf16 copy do not fit
the card together) and whose CLIP towers and projection are fp32 masters,
as in the T5 cells. Every tensor is drawn on the card from a generator of
its own, seeded from the seed and the tensor's name, in blocks of at most
``_DRAW`` elements (1 GiB of fp32), each block scaled and cast into the
parameter. So the check can draw any tensor again in fp32, alone, after
the window (:class:`Redraw`): the reference reads a layer at a time and
never holds the whole model.

Scales: the LM's matrices, embedding, head, router and correction bias
N(0, 0.02^2) (DeepSeek's ``initializer_range``; a trained correction bias
is not zero, so the bias's add is exercised), its norms 1; the CLIP
towers and the 512 -> hidden projection as ``portbench/weights.py`` draws
them (CLIP's published init, torch's Linear init).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Mapping, Tuple

import torch

from portbench import weights as t5_weights

# elements drawn in one call at most (1 GiB of fp32)
_DRAW = 1 << 28


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one tensor: 63 bits of a hash of (seed,
    name)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _spec(model_cfg, name: str, shape) -> Tuple[str, float]:
    """("fill", value) or ("normal", std) of a parameter."""
    if name.startswith("lm."):
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("norm"):
            return "fill", 1.0
        return "normal", model_cfg.lm.init_std
    blocks = t5_weights._specs(model_cfg, name, shape)
    if not blocks[0][0]:
        return "fill", blocks[0][1]
    return "normal", blocks[0][1]


def _fill(p: torch.Tensor, model_cfg, name: str, seed: int) -> None:
    """Draw ``p`` in place from (seed, name), whatever its dtype."""
    kind, value = _spec(model_cfg, name, p.shape)
    if kind == "fill":
        p.fill_(value)
        return
    gen = torch.Generator(device=p.device).manual_seed(
        tensor_seed(seed, name))
    flat = p.view(-1)
    for s in range(0, flat.numel(), _DRAW):
        n = min(_DRAW, flat.numel() - s)
        block = torch.randn(n, generator=gen, device=p.device)
        flat[s:s + n].copy_(block.mul_(value))
        del block


def _meta_model(model_cfg):
    from multimodalpromptretrieval_tpu_torch.models import moe_lm
    from multimodalpromptretrieval_tpu_torch.models.mprgen import MPRGen

    with torch.device("meta"):
        model = MPRGen(model_cfg, None)
        moe_lm.hold_in(model.lm, getattr(torch, model_cfg.compute_dtype))
    return model


def make_weights(model_cfg, seed: int, device: torch.device):
    """The program's :class:`MPRGen` at ``model_cfg`` (``lm`` set): the LM
    in the compute dtype (the correction biases fp32), the rest fp32,
    filled on ``device`` from ``seed``."""
    model = _meta_model(model_cfg).to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            _fill(p, model_cfg, name, seed)
    return model


class Redraw(Mapping):
    """The weights of :func:`make_weights` by name, in fp32, drawn again
    from the seed when read, in storage the program never held. The LM's
    layers are drawn at every read (the reference reads each once); the
    rest is kept once drawn."""

    def __init__(self, model_cfg, seed: int, device: torch.device):
        self.model_cfg, self.seed, self.device = model_cfg, seed, device
        self.shapes = {n: tuple(p.shape) for n, p in
                       _meta_model(model_cfg).named_parameters()}
        self._kept: Dict[str, torch.Tensor] = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._kept:
            return self._kept[name]
        if name not in self.shapes:
            raise KeyError(name)
        t = torch.empty(self.shapes[name], dtype=torch.float32,
                        device=self.device)
        _fill(t, self.model_cfg, name, self.seed)
        if not name.startswith("lm.layers."):
            self._kept[name] = t
        return t

    def __iter__(self) -> Iterator[str]:
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)
