"""Random weights of the Kimi-Linear configurations, drawn tensor by tensor
from (seed, name), as ``portbench/weights_lm.py`` draws the Kimi-VL ones
(its generators, blocks, ``make_weights`` layout and ``Redraw``), with the
initialisations that fla's ``KimiDeltaAttention`` gives its own tensors:

* ``A_log`` = log U(1, 16) a head;
* ``dt_bias`` = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1] a channel
  (at N(0, 0.02^2) every channel would decay by about a half a token, the
  state would forget within a chunk, and a fault in the chunked prefill's
  carry from one chunk to the next would not show);
* the convolution taps U(+-taps^-0.5), ``nn.Conv1d``'s default;
* every other matrix, the embedding, the head, the router and its
  correction bias N(0, 0.02^2); the norms 1; the CLIP towers and the
  projection as ``portbench/weights.py``.

The program holds ``A_log`` and ``dt_bias`` in fp32 and the rest of the LM
in the compute dtype (``moe_lm.hold_in``); the check draws any tensor again
in fp32 (:class:`Redraw`).
"""

from __future__ import annotations

import math

import torch

from portbench import weights_lm


def _draw(p: torch.Tensor, model_cfg, name: str, seed: int) -> None:
    """Draw ``p`` in place from (seed, name), whatever its dtype."""
    leaf = name.rsplit(".", 1)[-1]
    if not name.startswith("lm.") or leaf not in ("A_log", "dt_bias",
                                                  "conv"):
        weights_lm._fill(p, model_cfg, name, seed)
        return
    gen = torch.Generator(device=p.device).manual_seed(
        weights_lm.tensor_seed(seed, name))
    u = torch.rand(p.shape, generator=gen, device=p.device)
    if leaf == "A_log":
        u = torch.log(1 + 15 * u)
    elif leaf == "dt_bias":
        dt = torch.exp(math.log(1e-3) + math.log(100.0) * u).clamp(min=1e-4)
        u = dt + torch.log(-torch.expm1(-dt))
    else:
        u = (2 * u - 1) * p.shape[-1] ** -0.5
    p.copy_(u)


def make_weights(model_cfg, seed: int, device: torch.device):
    """The program's ``MPRGen`` at ``model_cfg`` (``lm`` set): the LM in
    the compute dtype (but ``moe_lm.FP32_WEIGHTS``), the rest fp32, filled
    on ``device`` from ``seed``."""
    model = weights_lm._meta_model(model_cfg).to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            _draw(p, model_cfg, name, seed)
    return model


class Redraw(weights_lm.Redraw):
    """The weights of :func:`make_weights` by name, in fp32, drawn again
    from the seed when read (``weights_lm.Redraw``'s keeping)."""

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._kept:
            return self._kept[name]
        if name not in self.shapes:
            raise KeyError(name)
        t = torch.empty(self.shapes[name], dtype=torch.float32,
                        device=self.device)
        _draw(t, self.model_cfg, name, self.seed)
        if not name.startswith("lm.layers."):
            self._kept[name] = t
        return t
