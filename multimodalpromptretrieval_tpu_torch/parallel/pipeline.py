"""GPipe pipeline parallelism of the T5 stacks over the "pipe" axis, with
Megatron tensor parallelism inside each stage (TP x PP).

Counterpart of ``multimodalpromptretrieval_tpu/parallel/pipeline.py``.
Stage ``s`` of ``S`` holds layers ``[s * L / S, (s + 1) * L / S)`` of both
stacks (``parallel/mesh.param_spec``); the embeddings, the vision tail, the
LM head and the norms outside the blocks are replicated. The generative
loss (:func:`pipeline_loss`) streams ``M`` microbatches through the
stages:

  * :class:`_Stage` (the JAX ``gpipe``): stage 0 injects each microbatch,
    each stage runs its blocks (``models/t5.encoder_block`` /
    ``decoder_block``, under ``tp`` on the rank's heads) and hands the
    activation to the next stage. A hop between neighbours is a
    ``broadcast`` in their two-process group: gloo's CUDA backend has
    ``broadcast`` and ``all_reduce`` only, and a broadcast moves the one
    tensor with no host copy of our own (NCCL, with a card a process, runs
    the same call). Each microbatch keeps its graph; the backward runs the
    microbatches in reverse order and hands each input's gradient back.
    The JAX schedule computes the bubble ticks on garbage and discards
    them; here a stage simply waits, so the results are the same;
  * the encoder output goes from the last stage to every stage's
    cross-attention (the JAX ``from_last``): a ``broadcast`` over "pipe";
    backward, every stage's cotangent of it is summed onto the last stage
    by an ``all_reduce`` over "pipe";
  * the loss is the last stage's summed log-likelihood of its data shard
    over the GLOBAL batch's valid token count, so that the sum over "pipe"
    and "data" is the one-process mean; under TP every model rank computes
    the head (its backward needs the whole residual cotangent) and the
    value is taken once.

Shared inputs of the microbatch graphs (the position biases, the encoder
output, the stage-0 embeddings) enter them as leaves cut from their own
graphs; each is back-propagated once, after every microbatch's backward.
Gradients accumulate in the ``.grad`` of the compute model's parameters;
:func:`parallel.mesh.merge_grads` then sums each over the axes along
which it is partial.

Dropout draws every mask of a step in one process's order at its global
shape (:func:`stage_masks`): each stage discards the draws of the sites it
does not hold and keeps each microbatch's rows, so a pipelined step
applies one process's masks. The JAX step draws from a per-(stage,
microbatch) key schedule instead; dropout bits are not a parity surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.models.t5 import (
    compute_position_bias,
    decoder_block,
    encoder_block,
    label_nll,
    lm_logits,
    remat_layer,
    shift_right,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    BatchShard,
    MaskTape,
    dropout,
    rms_norm,
)
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pm
from multimodalpromptretrieval_tpu_torch.train.optim import adamw_update


def check_pipeline(cfg: mprgen.MPRGenConfig, mesh: pm.Mesh) -> None:
    """The JAX ``make_train_step_pp`` checks, with its messages: the layers
    split into the stages, the heads and ``d_ff`` over "model"."""
    tc, S = cfg.t5, mesh.n_pipe
    if tc.num_layers % S or tc.num_decoder_layers % S:
        raise ValueError(
            f"{tc.num_layers}+{tc.num_decoder_layers} layers don't split "
            f"into {S} pipeline stages")
    pm.check_model_split(tc, mesh.n_model)


def _sites(tc, B: int, L: int, T: int):
    """(site, mask shape) of every dropout of the generative loss, in one
    process's order; a block's sites are named by (stack, layer)."""
    D, F = tc.d_model, tc.d_ff
    yield "enc_in", (B, L, D)
    for layer in range(tc.num_layers):
        for w in (D, F, D):
            yield ("enc", layer), (B, L, w)
    yield "enc_final", (B, L, D)
    yield "dec_in", (B, T, D)
    for layer in range(tc.num_decoder_layers):
        for w in (D, D, F, D):
            yield ("dec", layer), (B, T, w)
    yield "dec_final", (B, T, D)


def stage_masks(source, cfg: mprgen.MPRGenConfig, mesh: pm.Mesh, B: int,
                L: int, T: int, device) -> Dict[str, List[torch.Tensor]]:
    """The keep-masks this stage applies, by site ("enc_in", "enc",
    "enc_final", "dec_in", "dec", "dec_final"; a stack's list holds its
    local layers' sites in order), drawn from ``source`` (a
    ``BatchShard``: the data shard's rows of the global batch's masks) in
    one process's order over every site, the others' drawn and dropped."""
    tc, S, s = cfg.t5, mesh.n_pipe, mesh.stage
    per = {"enc": tc.num_layers // S, "dec": tc.num_decoder_layers // S}
    held = {"enc_in": s == 0, "dec_in": s == 0, "enc_final": True,
            "dec_final": s == S - 1}
    out: Dict[str, List[torch.Tensor]] = {}
    for site, shape in _sites(tc, B, L, T):
        mask = source.keep(shape, tc.dropout_rate, device)
        if isinstance(site, tuple):
            stack, layer = site
            if layer // per[stack] == s:
                out.setdefault(stack, []).append(mask)
        elif held[site]:
            out[site] = [mask]
    return out


class _Stage:
    """One stack's microbatches through this stage: the forward with its
    hops, each microbatch's (input, output) kept, and the backward."""

    def __init__(self, mesh: pm.Mesh, microbatches: int, shape, dtype,
                 device, train: bool):
        self.mesh, self.shape, self.train = mesh, tuple(shape), train
        self.microbatches = microbatches
        self.dtype, self.device = dtype, device
        self.first = mesh.stage == 0
        self.last = mesh.stage == mesh.n_pipe - 1
        self.ins: List[torch.Tensor] = []
        self.outs: List[torch.Tensor] = []

    def _hop(self, x: Optional[torch.Tensor], pair: int, src: int):
        """``x`` from stage ``src`` to the other stage of pair ``pair``
        (``x`` None: receive)."""
        m = self.mesh
        if x is None:
            x = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        else:
            x = x.detach().contiguous()
        pm.pair_broadcast(x, m.pipe, pair, src)
        return x

    def forward(self, fn, inputs: Optional[List[torch.Tensor]]) -> None:
        """``fn(x, m)`` over the microbatches: stage 0 takes ``inputs``,
        the others receive; every stage but the last sends on."""
        s = self.mesh.stage
        for m in range(self.microbatches):
            if self.first:
                x = inputs[m]
            else:
                x = self._hop(None, s - 1, s - 1)
                x.requires_grad_(self.train)
            y = fn(x, m)
            if not self.last:
                self._hop(y, s, s)
            self.ins.append(x)
            self.outs.append(y)

    def backward(self, grads: Optional[List[torch.Tensor]]) -> None:
        """The microbatches in reverse: the last stage takes ``grads`` (its
        outputs' cotangents), the others receive theirs; every stage but
        the first sends its inputs' gradients back."""
        s = self.mesh.stage
        for m in reversed(range(len(self.outs))):
            dy = grads[m] if self.last else self._hop(None, s, s + 1)
            torch.autograd.backward(self.outs[m], dy)
            if not self.first:
                self._hop(self.ins[m].grad, s - 1, s)


def _leaf(x: torch.Tensor, train: bool) -> torch.Tensor:
    """``x`` cut from its graph: a leaf that collects its gradient."""
    return x.detach().requires_grad_(train and x.requires_grad)


def _back(pairs) -> None:
    """Back-propagate each (tensor, its cut leaf) that got a gradient."""
    pairs = [(t, leaf.grad) for t, leaf in pairs if leaf.grad is not None]
    if pairs:
        torch.autograd.backward(*zip(*pairs))


def pipeline_loss(run: mprgen.MPRGen, cfg: mprgen.MPRGenConfig,
                  local: Dict[str, torch.Tensor], mesh: pm.Mesh,
                  microbatches: int, count: torch.Tensor,
                  masks: Optional[Dict[str, List[torch.Tensor]]] = None, *,
                  train: bool = False) -> torch.Tensor:
    """This rank's part of the generative loss of its data shard ``local``
    (the JAX ``pp_generative_loss`` with ``reduce=False``): on the last
    stage the summed log-likelihood over ``count``, the global batch's
    valid tokens, else 0 (fp32). ``run`` is the compute model in this
    stage's layout, ``masks`` :func:`stage_masks` (None: no dropout). With
    ``train`` the backward runs too and the gradients accumulate in the
    ``.grad`` of ``run``'s parameters."""
    tc = cfg.t5
    tp = pm.tp_axis(mesh)
    t5 = run.t5
    eps, rate = tc.layer_norm_epsilon, tc.dropout_rate
    ids, text_mask, labels = (local["input_ids"], local["text_mask"],
                              local["labels"])
    B, M = ids.shape[0], microbatches
    if B % M:
        raise ValueError(
            f"local batch {B} not divisible by {M} microbatches")
    mb = B // M
    prefix = cfg.num_image_tokens if cfg.use_image_info else 0
    L, T, D = prefix + ids.shape[1], labels.shape[1], tc.d_model
    dt, dev = mprgen.compute_dtype(cfg), ids.device
    first, last = mesh.stage == 0, mesh.stage == mesh.n_pipe - 1
    key_mask = text_mask
    if prefix:
        key_mask = torch.cat([torch.ones((B, prefix), dtype=text_mask.dtype,
                                         device=dev), text_mask], dim=1)

    def rows(m):
        return slice(m * mb, (m + 1) * mb)

    def tape(site, m=None):
        if masks is None:
            return None
        return MaskTape(masks[site], slice(None) if m is None else rows(m))

    # -- encoder -------------------------------------------------------
    enc = t5.encoder
    embeds = inputs = None
    if first:
        images, tokens = mprgen._batch_visual(local, cfg)
        embeds, _ = mprgen.combine_inputs(run, cfg, images, ids, text_mask,
                                          tokens)
        embeds = dropout(embeds, rate, tape("enc_in"))
        embeds_in = _leaf(embeds, train)
        inputs = [embeds_in[rows(m)] for m in range(M)]
    bias = compute_position_bias(enc.rel_bias, L, L, bidirectional=True,
                                 cfg=tc)
    bias_in = _leaf(bias, train)

    def enc_fn(x, m):
        t = tape("enc", m)
        for p in enc.block:
            x = remat_layer(tc, t, lambda x, p=p: encoder_block(
                p, tc, x, bias=bias_in, kv_mask=key_mask[rows(m)], gen=t,
                tp=tp), x)
        return x

    enc_stage = _Stage(mesh, M, (mb, L, D), dt, dev, train)
    enc_stage.forward(enc_fn, inputs)
    # from_last: the encoder output to every stage
    enc_out = (torch.cat([y.detach() for y in enc_stage.outs]) if last
               else torch.empty((B, L, D), dtype=dt, device=dev))
    dist.broadcast(enc_out, src=mesh.rank_of(mesh.index, mesh.n_pipe - 1,
                                             mesh.model_index),
                   group=mesh.pipe.group)
    enc_out.requires_grad_(train)
    enc_hidden = dropout(rms_norm(enc_out, enc.final_ln, eps), rate,
                         tape("enc_final"))
    hidden_in = _leaf(enc_hidden, train)

    # -- decoder -------------------------------------------------------
    dec = t5.decoder
    if first:
        y0 = dropout(t5.shared[shift_right(labels, tc).long()], rate,
                     tape("dec_in"))
        y0_in = _leaf(y0, train)
        inputs = [y0_in[rows(m)] for m in range(M)]
    dbias = compute_position_bias(dec.rel_bias, T, T, bidirectional=False,
                                  cfg=tc)
    dbias_in = _leaf(dbias, train)

    def dec_fn(y, m):
        t = tape("dec", m)
        for p in dec.block:
            y = remat_layer(tc, t, lambda y, p=p: decoder_block(
                p, tc, y, encoder_hidden=hidden_in[rows(m)], bias=dbias_in,
                enc_kv_mask=key_mask[rows(m)], gen=t, tp=tp), y)
        return y

    dec_stage = _Stage(mesh, M, (mb, T, D), dt, dev, train)
    dec_stage.forward(dec_fn, inputs)

    # -- head: the LM head and the cross-entropy on the last stage --------
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    out_in = None
    if last:
        out_in = torch.cat([y.detach() for y in dec_stage.outs])
        out_in.requires_grad_(train)
        logits = lm_logits(t5, tc, out_in, tape("dec_final"))
        loss = label_nll(logits, labels) / torch.clamp(count, min=1)
    if not train:
        return loss.detach()

    # -- backward ------------------------------------------------------
    if last:
        loss.backward()
        dec_stage.backward(list(out_in.grad.split(mb)))
    else:
        dec_stage.backward(None)
    _back([(enc_hidden, hidden_in), (dbias, dbias_in)]
          + ([(y0, y0_in)] if first else []))
    d_enc = enc_out.grad
    if d_enc is None:
        d_enc = torch.zeros_like(enc_out)
    d_enc = pm.sum_over(d_enc.float(), mesh.pipe).to(dt)
    enc_stage.backward(list(d_enc.split(mb)) if last else None)
    _back([(bias, bias_in)] + ([(embeds, embeds_in)] if first else []))
    return loss.detach()


def _grads(run: mprgen.MPRGen):
    """The accumulated gradients of ``run``'s trainable parameters by name
    (None where the stage's graph does not reach), cleared from them; and
    the parameters."""
    wanted = {n: p for n, p in run.named_parameters() if p.requires_grad}
    grads = {}
    for n, p in wanted.items():
        grads[n], p.grad = p.grad, None
    return grads, wanted


def _masks(gen, cfg, mesh: pm.Mesh, local) -> Optional[dict]:
    if gen is None or cfg.t5.dropout_rate <= 0.0:
        return None
    ids = local["input_ids"]
    prefix = cfg.num_image_tokens if cfg.use_image_info else 0
    return stage_masks(BatchShard(gen, mesh.index, mesh.n_data), cfg, mesh,
                       ids.shape[0], prefix + ids.shape[1],
                       local["labels"].shape[1], ids.device)


def make_train_step_pp(cfg: mprgen.MPRGenConfig, trainable=None,
                       compute=None, *, mesh: pm.Mesh,
                       microbatches: int = 0):
    """fn(params, opt_state, batch, lr, gen) -> loss, the signature of
    ``train/step.make_train_step``: ``params`` and ``opt_state`` in this
    rank's layout (``parallel/mesh.shard_params`` / ``shard_state``),
    updated in place; ``batch`` the global batch. ``microbatches`` defaults
    to the stage count; ``gen`` draws one process's dropout masks."""
    from multimodalpromptretrieval_tpu_torch.train.step import ComputeCopy

    check_pipeline(cfg, mesh)
    M = microbatches or mesh.n_pipe
    compute = compute or ComputeCopy()
    ready = []

    def step(params, opt_state, batch, lr, gen=None):
        if not ready:
            ready.append(None)
            if trainable is not None:
                mprgen.set_trainable(params, trainable)
                compute.model = None
        run = mprgen.cast_compute(params, cfg, out=compute.of(params, cfg))
        local = pm.shard_batch(batch, mesh)
        loss = pipeline_loss(run, cfg, local, mesh, M,
                             torch.sum(batch["labels"] != -100),
                             _masks(gen, cfg, mesh, local), train=True)
        grads, like = _grads(run)
        loss = pm.merge_grads(grads, like, loss, mesh)
        adamw_update(params, grads, opt_state, lr, trainable=trainable)
        return loss.detach()

    return step


def make_eval_loss_step_pp(cfg: mprgen.MPRGenConfig, compute=None, *,
                           mesh: pm.Mesh, microbatches: int = 0):
    """fn(params, batch) -> the global batch's mean loss, without dropout
    (the same forward as the train step)."""
    from multimodalpromptretrieval_tpu_torch.train.step import ComputeCopy

    check_pipeline(cfg, mesh)
    M = microbatches or mesh.n_pipe
    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        run = mprgen.cast_compute(params, cfg, out=compute.of(params, cfg))
        loss = pipeline_loss(run, cfg, pm.shard_batch(batch, mesh), mesh,
                             M, torch.sum(batch["labels"] != -100))
        return pm.sum_over(pm.sum_over(loss, mesh.pipe), mesh.data)

    return step
