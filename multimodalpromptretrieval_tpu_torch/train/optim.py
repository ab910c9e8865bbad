"""AdamW over the model's parameters + host-side ReduceLROnPlateau.

Counterpart of ``multimodalpromptretrieval_tpu/train/optim.py``, which
reproduces ``torch.optim.AdamW(lr=lr)`` and
``torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer)`` with all defaults:

  * AdamW: betas (0.9, 0.999), eps 1e-8, weight_decay 1e-2, bias-corrected
    moments, decoupled weight decay on the *current* params before the Adam
    step;
  * ReduceLROnPlateau: mode 'min', factor 0.1, patience 10, threshold 1e-4
    (relative), cooldown 0, min_lr 0.

The update is the JAX formula, ``lr * (m / c1) / (sqrt(v / c2) + eps)``;
``torch.optim.AdamW`` computes ``sqrt(v) / sqrt(c2) + eps``, which differs
in the last bits, and trajectories drift apart. State is plain tensors
keyed by parameter name: ``{"mu": {name: t}, "nu": {name: t}, "step": int}``.
A boolean ``trainable`` mask by name freezes parameters (the CLIP towers
always; everything but the shared embedding under ``freeze``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

State = Dict[str, Any]


def _dtype(moments_dtype) -> Optional[torch.dtype]:
    if moments_dtype is None or isinstance(moments_dtype, torch.dtype):
        return moments_dtype
    return getattr(torch, str(moments_dtype))


def adamw_init(params: nn.Module, moments_dtype=None) -> State:
    """Zero AdamW state. ``moments_dtype`` (``torch.bfloat16`` or the config
    string "bfloat16") stores mu / nu at reduced precision; the moment math
    still runs in fp32 inside :func:`adamw_update` (cast up, update, round
    to nearest back down). The default keeps fp32 moments."""
    dt = _dtype(moments_dtype)

    def zeros():
        return {name: torch.zeros_like(p, dtype=dt or p.dtype)
                for name, p in params.named_parameters()}

    return {"mu": zeros(), "nu": zeros(), "step": 0}


@torch.no_grad()
def adamw_update(params: nn.Module, grads: Dict[str, torch.Tensor],
                 state: State, lr, *, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2,
                 trainable: Optional[Dict[str, bool]] = None) -> None:
    """One AdamW step, in place on ``params`` and ``state``. ``grads`` maps
    parameter names to gradients (any float dtype; a trainable parameter
    without an entry counts as a zero gradient); parameters whose
    ``trainable`` entry is False are skipped, moments included."""
    state["step"] += 1
    # the scalars in fp32, as the JAX update computes them
    f32 = torch.float32
    step = torch.tensor(state["step"], dtype=f32)
    c1 = (1.0 - torch.tensor(beta1, dtype=f32) ** step).item()
    c2 = (1.0 - torch.tensor(beta2, dtype=f32) ** step).item()
    lr32 = torch.as_tensor(lr, dtype=f32).cpu()
    decay = (1.0 - lr32 * weight_decay).item()
    lr32 = lr32.item()

    ps, gs, ms, vs = [], [], [], []
    for name, p in params.named_parameters():
        if trainable is not None and not trainable[name]:
            continue
        g = grads.get(name)
        ps.append(p)
        gs.append(torch.zeros_like(p, dtype=f32) if g is None
                  else g.to(f32))
        ms.append(state["mu"][name])
        vs.append(state["nu"][name])
    if not ps:
        return
    mf = [m.to(f32) for m in ms]  # the same tensor where already fp32
    vf = [v.to(f32) for v in vs]
    torch._foreach_mul_(mf, beta1)
    torch._foreach_add_(mf, torch._foreach_mul(gs, 1.0 - beta1))
    torch._foreach_mul_(vf, beta2)
    torch._foreach_add_(vf, torch._foreach_mul(
        torch._foreach_mul(gs, gs), 1.0 - beta2))
    # decoupled decay on the current params, then the Adam step
    torch._foreach_mul_(ps, decay)
    num = torch._foreach_mul(torch._foreach_div(mf, c1), lr32)
    den = torch._foreach_sqrt(torch._foreach_div(vf, c2))
    torch._foreach_add_(den, eps)
    torch._foreach_sub_(ps, torch._foreach_div(num, den))
    for m, v, m32, v32 in zip(ms, vs, mf, vf):
        if m32 is not m:  # reduced-precision storage: round back down
            m.copy_(m32)
            v.copy_(v32)


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau with default arguments
    (mode='min', factor=0.1, patience=10, threshold=1e-4 rel, cooldown=0).
    Host-side: the returned lr feeds the update as a scalar."""

    lr: float
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        # torch 'rel' threshold_mode: better if metric < best * (1 - thr)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr
