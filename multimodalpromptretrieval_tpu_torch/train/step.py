"""The device steps of training, on one device.

Counterpart of the step makers in
``multimodalpromptretrieval_tpu/parallel/mesh.py`` without a mesh: plain
closures over the model config. The train step is
``value_and_grad(mprgen.loss_fn)`` then ``adamw_update``, updating the
module and the optimizer state in place and returning the loss as a
tensor on the device (no host sync). ``loss_fn`` and ``predict_fn``
dispatch on the variant (generative, text-only, prediction head, BAN), so
one maker serves them all.

Under a reduced compute dtype every step runs on one compute-dtype copy of
the model (:class:`ComputeCopy`), refreshed from the fp32 masters at each
call; the train step reads the copy's gradients and hands them, upcast, to
the update (``mprgen.cast_compute``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.train.optim import adamw_update


class ComputeCopy:
    """The compute-dtype copy of a model, made at first use; the masters
    themselves under float32. Steps that share one holder share the copy."""

    def __init__(self):
        self.model: Optional[mprgen.MPRGen] = None

    def of(self, params: mprgen.MPRGen,
           cfg: mprgen.MPRGenConfig) -> mprgen.MPRGen:
        if self.model is None or cfg.compute_dtype == "float32":
            self.model = mprgen.cast_compute(params, cfg)
        return self.model


def backward(loss: torch.Tensor,
             run: mprgen.MPRGen) -> Dict[str, torch.Tensor]:
    """Gradients of ``loss`` by name, for the parameters of the model it was
    computed on that require grad (None where the loss does not reach)."""
    wanted = {n: p for n, p in run.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(wanted.values()),
                                allow_unused=True)
    return dict(zip(wanted, grads))


def make_train_step(cfg: mprgen.MPRGenConfig,
                    trainable: Optional[Dict[str, bool]] = None,
                    compute: Optional[ComputeCopy] = None):
    """fn(params, opt_state, batch, lr, gen) -> loss (device tensor);
    ``params`` and ``opt_state`` are updated in place. ``trainable`` (name
    -> bool, ``mprgen.trainable_mask``) also switches off autograd for the
    frozen parameters at the first call."""
    compute = compute or ComputeCopy()
    ready = []

    def step(params, opt_state, batch, lr, gen=None):
        if not ready:
            ready.append(None)
            if trainable is not None:
                mprgen.set_trainable(params, trainable)
                compute.model = None  # made anew, with these flags
        run = compute.of(params, cfg)
        loss = mprgen.loss_fn(params, cfg, batch, gen, compute=run)
        adamw_update(params, backward(loss, run), opt_state, lr,
                     trainable=trainable)
        return loss.detach()

    return step


def make_eval_loss_step(cfg: mprgen.MPRGenConfig,
                        compute: Optional[ComputeCopy] = None):
    """fn(params, batch) -> the batch's mean loss (device tensor), without
    dropout."""
    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        return mprgen.loss_fn(params, cfg, batch,
                              compute=compute.of(params, cfg))

    return step


def make_predict_step(cfg: mprgen.MPRGenConfig, *, max_new_tokens: int = 20,
                      compute: Optional[ComputeCopy] = None):
    """fn(params, batch) -> greedy token ids (generative variants) or
    int32 class ids (head variants)."""
    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        return mprgen.predict_fn(params, cfg, batch, max_new_tokens,
                                 compute=compute.of(params, cfg))

    return step


def make_vision_tokens_step(cfg: mprgen.MPRGenConfig,
                            compute: Optional[ComputeCopy] = None):
    """fn(params, images) -> the frozen ViT trunk's tokens (B, P, C): the
    part of the visual path that training computes once per image."""
    compute = compute or ComputeCopy()

    def step(params, images):
        run = mprgen.cast_compute(params, cfg, out=compute.of(params, cfg))
        return mprgen.vision_trunk(run, cfg,
                                   images.to(mprgen.compute_dtype(cfg)))

    return step
