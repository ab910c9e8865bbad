"""Random weights made on the device from the seed.

The benchmark makes the weights and hands them to the program as its fp32
master :class:`MPRGen`. The reference gets the same weights drawn again
from the seed once the window has closed (:func:`redraw`), in storage of
its own: a change the program makes to its weights in place cannot reach
the reference. The module is built on the meta device, its storage
allocated on the card, and every tensor filled from one
``torch.Generator`` on the card in a few large draws: the program's
host-side ``init_mprgen`` is neither timed in set-up nor read by the
reference.

Scales follow the models' published inits (T5's factor init, CLIP's), so
the seeded model behaves as the program's own seeded init does: its greedy
decode never emits EOS within 20 steps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# elements drawn in one call at most (1 GiB of fp32)
_DRAW = 1 << 28


def _specs(model_cfg, name: str, shape) -> List[Tuple[int, float]]:
    """(rows, std) blocks of a parameter, or [(0, fill)] for a constant."""
    t5, clip = model_cfg.t5, model_cfg.clip
    d, inner = t5.d_model, t5.num_heads * t5.d_kv
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("t5."):
        if name == "t5.shared":
            return [(shape[0], 1.0)]
        if leaf.endswith("_ln"):
            return [(0, 1.0)]
        if leaf == "rel_bias":
            return [(shape[0], inner ** -0.5)]
        if leaf == "qkv":
            return [(inner, (d * t5.d_kv) ** -0.5), (2 * inner, d ** -0.5)]
        if ".o." in name:
            return [(shape[0], inner ** -0.5)]
        if ".wo." in name:
            return [(shape[0], t5.d_ff ** -0.5)]
        return [(shape[0], d ** -0.5)]  # wi, wi_0, wi_1
    if name == "clip.logit_scale":
        return [(0, 2.6592)]
    if leaf == "bias":
        return [(0, 0.0)]
    if ".ln_" in name:
        return [(0, 1.0)]
    if name.startswith("proj."):
        # torch's Linear init, U(-a, a) with a = in^-0.5: its variance
        return [(shape[0], clip.embed_dim ** -0.5 / 3 ** 0.5)]
    width = (clip.vision_width if name.startswith("clip.visual.")
             else clip.text_width)
    if name == "clip.text.token_embedding":
        return [(shape[0], 0.02)]
    if name == "clip.text.pos_embedding":
        return [(shape[0], 0.01)]
    return [(shape[0] if len(shape) else 1, width ** -0.5)]


def make_weights(model_cfg, seed: int, device: torch.device):
    """The program's fp32 master :class:`MPRGen` at ``model_cfg``, filled
    on ``device`` from ``seed``, and the same tensors by name."""
    from multimodalpromptretrieval_tpu_torch.models.mprgen import MPRGen

    with torch.device("meta"):
        model = MPRGen(model_cfg, None)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = dict(model.named_parameters())
    drawn = [(n, p) for n, p in params.items()
             if _specs(model_cfg, n, p.shape)[0][0]]
    with torch.no_grad():
        for n, p in params.items():
            spec = _specs(model_cfg, n, p.shape)
            if not spec[0][0]:
                p.fill_(spec[0][1])
        # a few large draws, each cut into the parameters in name order
        i = 0
        while i < len(drawn):
            batch, size = [], 0
            while i < len(drawn) and (not batch
                                      or size + drawn[i][1].numel() <= _DRAW):
                batch.append(drawn[i])
                size += drawn[i][1].numel()
                i += 1
            buf = torch.randn(size, generator=gen, device=device)
            off = 0
            for n, p in batch:
                flat = buf[off:off + p.numel()].view(p.shape)
                off += p.numel()
                row = 0
                for rows, std in _specs(model_cfg, n, p.shape):
                    p[row:row + rows].copy_(flat[row:row + rows] * std)
                    row += rows
            del buf
    named: Dict[str, torch.Tensor] = {n: p.detach() for n, p in
                                      params.items()}
    return model, named


def redraw(model_cfg, seed: int, device: torch.device
           ) -> Dict[str, torch.Tensor]:
    """The weights of :func:`make_weights` drawn again from ``seed``, by
    name, in storage that the program never held (for the reference)."""
    return make_weights(model_cfg, seed, device)[1]
