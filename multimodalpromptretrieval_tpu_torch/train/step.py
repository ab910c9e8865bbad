"""The device steps of training, on one device or over a mesh.

Counterpart of the step makers in
``multimodalpromptretrieval_tpu/parallel/mesh.py``: plain closures over the
model config. With ``mesh=`` (a ``parallel.mesh.Mesh``) each step takes
the GLOBAL batch, runs its data index's rows and adds the collectives of
``parallel/mesh.py``: with "model" above 1 on the rank's shards of the T5
blocks (Megatron TP, ``tp`` down to ``models/t5.py``); with "pipe" above 1
the train and eval-loss steps are ``parallel/pipeline.py``'s (GPipe, with
TP inside each stage). Parameters and AdamW moments are in the rank's
layout (``parallel/mesh.shard_params``); with "seq" above 1 they are
``parallel/sequence.py``'s (the ring-attention encoder, the parameters
replicated). The train step is
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
from multimodalpromptretrieval_tpu_torch.ops.layers import BatchShard
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pm
from multimodalpromptretrieval_tpu_torch.parallel.pipeline import (
    make_eval_loss_step_pp,
    make_train_step_pp,
)
from multimodalpromptretrieval_tpu_torch.parallel.sequence import (
    make_eval_loss_step_sp,
    make_train_step_sp,
)
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
                    compute: Optional[ComputeCopy] = None, mesh=None,
                    microbatches: int = 0):
    """fn(params, opt_state, batch, lr, gen) -> loss (device tensor);
    ``params`` and ``opt_state`` are updated in place. ``trainable`` (name
    -> bool, ``mprgen.trainable_mask``) also switches off autograd for the
    frozen parameters at the first call. With ``mesh``: the loss of the
    global batch, from this data index's rows, each gradient summed over
    the axes along which it is partial and one ``all_reduce`` over "data"
    of the weighted loss and the gradients (``parallel/mesh.py``); with
    "pipe" the pipelined step over ``microbatches``, with "seq" the
    sequence-parallel step."""
    if mesh is not None and mesh.n_pipe > 1:
        return make_train_step_pp(cfg, trainable, compute, mesh=mesh,
                                  microbatches=microbatches)
    if mesh is not None and mesh.n_seq > 1:
        return make_train_step_sp(cfg, trainable, compute, mesh=mesh)
    if mesh is not None:
        pm.check_model_split(cfg.t5, mesh.n_model)
    tp = pm.tp_axis(mesh)
    compute = compute or ComputeCopy()
    ready = []

    def step(params, opt_state, batch, lr, gen=None):
        if not ready:
            ready.append(None)
            if trainable is not None:
                mprgen.set_trainable(params, trainable)
                compute.model = None  # made anew, with these flags
        run = compute.of(params, cfg)
        if mesh is None:
            loss = mprgen.loss_fn(params, cfg, batch, gen, compute=run)
            grads = backward(loss, run)
        else:
            local = pm.shard_batch(batch, mesh)
            shard = (None if gen is None
                     else BatchShard(gen, mesh.index, mesh.n_data))
            loss = (mprgen.loss_fn(params, cfg, local, shard, compute=run,
                                   tp=tp)
                    * pm.loss_weight(cfg, batch, local))
            grads = backward(loss, run)
            loss = pm.merge_grads(grads, dict(run.named_parameters()), loss,
                                  mesh)
        adamw_update(params, grads, opt_state, lr, trainable=trainable)
        return loss.detach()

    return step


def make_eval_loss_step(cfg: mprgen.MPRGenConfig,
                        compute: Optional[ComputeCopy] = None, mesh=None,
                        microbatches: int = 0):
    """fn(params, batch) -> the batch's mean loss (device tensor), without
    dropout; with ``mesh``, the sum over "data" of the weighted losses (the
    pipelined forward with "pipe", the sequence-parallel one with
    "seq")."""
    if mesh is not None and mesh.n_pipe > 1:
        return make_eval_loss_step_pp(cfg, compute, mesh=mesh,
                                      microbatches=microbatches)
    if mesh is not None and mesh.n_seq > 1:
        return make_eval_loss_step_sp(cfg, compute, mesh=mesh)
    tp = pm.tp_axis(mesh)
    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        run = compute.of(params, cfg)
        if mesh is None:
            return mprgen.loss_fn(params, cfg, batch, compute=run)
        local = pm.shard_batch(batch, mesh)
        return pm.sum_over(mprgen.loss_fn(params, cfg, local, compute=run,
                                          tp=tp)
                           * pm.loss_weight(cfg, batch, local), mesh.data)

    return step


def make_predict_step(cfg: mprgen.MPRGenConfig, *, max_new_tokens: int = 20,
                      compute: Optional[ComputeCopy] = None, mesh=None):
    """fn(params, batch) -> greedy token ids (generative variants) or
    int32 class ids (head variants); with ``mesh``, each data index
    predicts its rows (tensor-parallel over "model", the parameters in the
    un-pipelined layout: ``shard_params`` over ``mesh.unpipelined()``) and
    the rows are gathered in order."""
    tp = pm.tp_axis(mesh)
    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        run = compute.of(params, cfg)
        if mesh is None:
            return mprgen.predict_fn(params, cfg, batch, max_new_tokens,
                                     compute=run)
        return pm.gather_rows(mprgen.predict_fn(
            params, cfg, pm.shard_batch(batch, mesh), max_new_tokens,
            compute=run, tp=tp), mesh)

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
