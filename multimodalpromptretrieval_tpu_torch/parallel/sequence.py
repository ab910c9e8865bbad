"""Sequence (context) parallelism: ring attention over the "seq" axis of a
process mesh, and the T5 encoder, loss and steps built on it.

Counterpart of ``multimodalpromptretrieval_tpu/parallel/sequence.py``,
function for function, over the ``torch.distributed`` group of
``parallel/multihost.py`` (``parallel/mesh.Mesh`` with ``n_seq > 1``). Seq
rank ``s`` of ``n`` holds the contiguous chunk ``[s * Lc, (s + 1) * Lc)``
of the sequence; the parameters are replicated.

  * :func:`ring_attention`: exact attention over the chunks. Each rank
    keeps an fp32 online softmax, ``m`` started at -1e9 (not -inf, as the
    JAX scan), and adds the ring's K/V chunks in the JAX order: at step t
    the chunk of rank ``(s - t) mod n``. Masked scores are REPLACED by
    -1e9, the global causal mask reads global query and key indices, and
    the result is cast to ``q``'s dtype. A fully masked tile seen first is
    then wiped by the first unmasked one (its correction ``exp(-1e9 - m)``
    is 0), and a row whose every key is masked averages V uniformly, as the
    one-shot ``-1e9`` softmax does;
  * :func:`ring_hop`: one step of the ring, a pair ``broadcast`` per
    neighbour pair (gloo's CUDA backend has ``broadcast`` and
    ``all_reduce`` only; NCCL runs the same call). Every rank issues the
    ring's hops in one global order, pair ``(i, i + 1 mod n)`` from ``i``
    for ``i = 0 .. n - 1``, sends from one buffer and receives into
    another. It is an autograd Function: the backward sends the cotangent
    the other way round the ring, and autograd runs the hops' backwards in
    one order on every rank (the ranks build the same graph);
  * :func:`sp_t5_encode`: the whole T5 encoder stack over ("data",
    "seq"), the relative-position bias computed per tile from the bucket
    of ``(k_off + j) - (q_off + i)`` (an (H, L, L) table is never built);
  * :func:`sp_generative_loss`: the replicated front end, a zero-padded
    masked tail for a length that does not divide, the ring encoder on
    the rank's chunk, the encoder states gathered over "seq" (a sum of
    zero-filled buffers; backward, the cotangent summed over "seq" and the
    rank's chunk kept: the transpose of an all-gather), the replicated
    decoder, seq rank 0's log-likelihood over the GLOBAL valid-label
    count;
  * :func:`make_train_step_sp`, :func:`make_eval_loss_step_sp`,
    :func:`make_sp_attention`.

Plain torch and collectives: the ring's tile math is the JAX einsums; no
kernel runs here. Dropout draws each site's mask at the one-process shape
(the global batch, the unpadded length) in one process's order, and each
rank keeps its rows and its sequence chunk (:class:`SeqChunk`), so an SP
step applies one process's masks. The JAX step draws from a per-rank key
schedule instead; dropout bits are not a parity surface.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.models.t5 import (
    T5,
    T5Config,
    encoder_block,
    label_nll,
    relative_position_bucket,
    shift_right,
    t5_decode_train,
)
from multimodalpromptretrieval_tpu_torch.ops.layers import (
    BatchShard,
    dropout,
    rms_norm,
)
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pm
from multimodalpromptretrieval_tpu_torch.train.optim import adamw_update

_NEG_INF = -1e9  # the masking value of ops/attention.attention_xla


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def _ring_pass(x: torch.Tensor, axis: pm.Axis, forward: bool) -> torch.Tensor:
    """``x`` to the next position of the ring (``forward``) or to the
    previous one; returns what arrives from the other side. The hops in one
    global order: pair ``(i, i + 1 mod n)`` for ``i = 0 .. n - 1``."""
    n, s = axis.size, axis.index
    x = x.contiguous()
    out = torch.empty_like(x)
    for i in range(n):
        src, dst = (i, (i + 1) % n) if forward else ((i + 1) % n, i)
        if s in (src, dst):
            pm.pair_broadcast(x if s == src else out, axis, i, src)
    return out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _ring_pass(x, axis, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _ring_pass(g, ctx.axis, forward=False), None


def ring_hop(x: torch.Tensor, axis: pm.Axis) -> torch.Tensor:
    """``x`` sent to the next rank of the ring ``axis`` (a mesh's "seq"),
    and what the previous rank sent. Differentiable: the cotangent goes the
    other way round."""
    return _RingHop.apply(x, axis)


def _hop_kv(k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            axis: pm.Axis):
    """One ring step of a K/V chunk and its key mask, in one buffer."""
    flat = ring_hop(torch.cat([k.reshape(-1), v.reshape(-1),
                               mask.to(k.dtype).reshape(-1)]), axis)
    nk = k.numel()
    return (flat[:nk].view(k.shape), flat[nk:2 * nk].view(v.shape),
            flat[2 * nk:].view(mask.shape) > 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: pm.Axis, bias: Optional[torch.Tensor] = None,
                   bias_tile_fn=None, kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over sequence-sharded q, k, v (module docstring).

    q, k, v: (B, H, Lc, Dh), this rank's contiguous chunk (the global
    length is ``axis.size * Lc``). ``bias``: an additive bias over GLOBAL
    positions, (1|B, H, L, L), the same on every rank; each ring step
    slices its tile. ``bias_tile_fn(q_off, k_off) -> (H|1, Lc, Lc)``: the
    tile made on the fly instead (:func:`t5_bias_tiles`). ``kv_mask``:
    (B, Lc) validity of this rank's keys; it travels the ring with k and
    v. ``causal``: the global causal mask. ``scale``: ``1 / sqrt(Dh)`` by
    default; T5 passes 1.0. Returns (B, H, Lc, Dh) in ``q``'s dtype."""
    B, H, Lc, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    n, s = axis.size, axis.index
    dev = q.device
    qf = q.float()
    m = torch.full((B, H, Lc), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Lc, Dh), dtype=torch.float32, device=dev)
    mask = (torch.ones((B, Lc), dtype=torch.bool, device=dev)
            if kv_mask is None else kv_mask.bool())
    pos = torch.arange(Lc, device=dev)
    for t in range(n):
        src = (s - t) % n  # after t hops this rank holds src's chunk
        scores = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
        if bias is not None:
            scores = scores + bias[:, :, s * Lc:(s + 1) * Lc,
                                   src * Lc:(src + 1) * Lc].float()
        if bias_tile_fn is not None:
            scores = scores + bias_tile_fn(s * Lc, src * Lc).float()[None]
        scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
        if causal:
            later = (src * Lc + pos)[None, :] > (s * Lc + pos)[:, None]
            scores = torch.where(later, _NEG_INF, scores)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, v.float())
        m = m_new
        if t + 1 < n:  # the last step's chunks would only go home
            k, v, mask = _hop_kv(k, v, mask, axis)
    return (acc / l[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    """``x`` as block ``where`` of a zero-filled fp32 buffer of ``shape``,
    summed over ``group``: every rank's block on every rank. Backward: the
    cotangent summed over ``group``, this rank's block of it (the
    transpose of an all-gather)."""

    @staticmethod
    def forward(ctx, x, shape, where, group):
        ctx.where, ctx.group, ctx.dtype = where, group, x.dtype
        buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
        buf[where] = x
        dist.all_reduce(buf, group=group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32, copy=True)
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.where].to(ctx.dtype), None, None, None


def _chunk(mesh: pm.Mesh, Lc: int) -> slice:
    return slice(mesh.seq_index * Lc, (mesh.seq_index + 1) * Lc)


def _rows(mesh: pm.Mesh, b: int) -> slice:
    return slice(mesh.index * b, (mesh.index + 1) * b)


def gather_seq(x: torch.Tensor, mesh: pm.Mesh, dim: int = 1) -> torch.Tensor:
    """The seq ranks' chunks of ``x`` along ``dim``, concatenated in order
    (differentiable)."""
    if mesh.n_seq == 1:
        return x
    shape = list(x.shape)
    Lc = shape[dim]
    shape[dim] = Lc * mesh.n_seq
    where = (slice(None),) * dim + (_chunk(mesh, Lc),)
    return _Gather.apply(x, tuple(shape), where, mesh.seq.group)


def gather_global(x: torch.Tensor, mesh: pm.Mesh,
                  dim: int = 1) -> torch.Tensor:
    """Every rank's (rows, sequence chunk along ``dim``) block of ``x`` in
    place in the global tensor (differentiable): "data" over dim 0, "seq"
    over ``dim``."""
    if mesh.n_data * mesh.n_seq == 1:
        return x
    shape = list(x.shape)
    b, Lc = shape[0], shape[dim]
    shape[0], shape[dim] = b * mesh.n_data, Lc * mesh.n_seq
    where = ((_rows(mesh, b),) + (slice(None),) * (dim - 1)
             + (_chunk(mesh, Lc),))
    return _Gather.apply(x, tuple(shape), where, mesh.batch_axes.group)


# ---------------------------------------------------------------------------
# The T5 encoder over "seq"
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _diff_buckets(length: int, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """The bidirectional bucket of each key - query difference
    ``-(length - 1) .. length - 1``, made on the host as
    ``models/t5._buckets`` makes its table (outside inference mode, for
    the same reason)."""
    with torch.inference_mode(False):
        rel = torch.arange(-(length - 1), length, dtype=torch.int32)
        return relative_position_bucket(
            rel, bidirectional=True, num_buckets=num_buckets,
            max_distance=max_distance).long()


def t5_bias_tiles(rel_table: torch.Tensor, cfg: T5Config, length: int,
                  Lc: int):
    """``tile(q_off, k_off) -> (H, Lc, Lc)``: T5's bidirectional relative
    position bias of the (query chunk at ``q_off``, key chunk at ``k_off``)
    tile of a sequence of ``length``, from the bucket of each position
    difference (``rel_table`` (buckets, H), the stack's ``rel_bias``)."""
    table = _diff_buckets(length, cfg.relative_attention_num_buckets,
                          cfg.relative_attention_max_distance).to(
                              rel_table.device)
    pos = torch.arange(Lc, device=rel_table.device)
    diff = pos[None, :] - pos[:, None] + (length - 1)

    def tile(q_off: int, k_off: int) -> torch.Tensor:
        return rel_table[table[diff + (k_off - q_off)]].permute(2, 0, 1)

    return tile


class SeqChunk:
    """Dropout masks of ``source`` (a ``BatchShard``) drawn with the
    sequence (dim 1) at its one-process ``length``, padded with keeps to
    ``count`` chunks and chunk ``index`` kept: a seq rank's part of the
    mask one process draws."""

    def __init__(self, source, length: int, index: int, count: int):
        self.source, self.length = source, length
        self.index, self.count = index, count

    def keep(self, shape, rate: float, device) -> torch.Tensor:
        b, Lc, rest = shape[0], shape[1], tuple(shape[2:])
        full = self.source.keep((b, self.length) + rest, rate, device)
        pad = Lc * self.count - self.length
        if pad:
            full = torch.cat([full, full.new_ones((b, pad) + rest)], dim=1)
        return full[:, self.index * Lc:(self.index + 1) * Lc]


def _encode_chunk(enc, cfg: T5Config, x: torch.Tensor, mask: torch.Tensor,
                  axis: pm.Axis, length: int, source=None) -> torch.Tensor:
    """The encoder stack (``models/t5.encoder_block``, whose norms are the
    plain ``rms_norm``) over this rank's chunk ``x`` (b, Lc, D) with its
    key mask (b, Lc): every attention a ring over ``axis``, its bias per
    tile over a sequence of ``length``; the final norm and its dropout.
    ``source`` draws the dropout masks of the blocks and the final norm."""
    eps, rate = cfg.layer_norm_epsilon, cfg.dropout_rate
    ring = functools.partial(
        ring_attention, axis=axis, kv_mask=mask, scale=1.0,
        bias_tile_fn=t5_bias_tiles(enc.rel_bias, cfg, length, x.shape[1]))
    for p in enc.block:
        x = encoder_block(p, cfg, x, bias=None, kv_mask=mask, gen=source,
                          attention=ring)
    return dropout(rms_norm(x, enc.final_ln, eps), rate, source)


@torch.no_grad()
def sp_t5_encode(params: T5, cfg: T5Config, embeds: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 mesh: pm.Mesh) -> torch.Tensor:
    """The T5 encoder stack over a ("data", "seq") mesh, without dropout:
    global (B, L, D) ``embeds`` and (B, L) ``mask`` in (the same on every
    process), global (B, L, D) encoder states out, on every process. Each
    rank runs its data index's rows and its sequence chunk; every
    attention is a ring and the position bias is made per tile, so an (H,
    L, L) table is never built. The states of ``models/t5.t5_encode`` up to
    the ring's summation order."""
    B, L = embeds.shape[0], embeds.shape[1]
    if B % mesh.n_data or L % mesh.n_seq:
        raise ValueError(
            f"sp_t5_encode: batch {B} must divide over the 'data' axis "
            f"({mesh.n_data}) and sequence length {L} over the 'seq' axis "
            f"({mesh.n_seq}); pad the batch/sequence or shrink the mesh")
    if mask is None:
        mask = torch.ones((B, L), dtype=torch.bool, device=embeds.device)
    b, Lc = B // mesh.n_data, L // mesh.n_seq
    block = (_rows(mesh, b), _chunk(mesh, Lc))
    out = _encode_chunk(params.encoder, cfg, embeds[block], mask[block],
                        mesh.seq, L)
    return gather_global(out, mesh)


# ---------------------------------------------------------------------------
# The generative loss and the steps
# ---------------------------------------------------------------------------


def sp_generative_loss(params: mprgen.MPRGen, cfg: mprgen.MPRGenConfig,
                       batch: Dict[str, torch.Tensor], mesh: pm.Mesh,
                       count: torch.Tensor, source=None, *,
                       reduce: bool = True) -> torch.Tensor:
    """The generative cross-entropy over a ("data", "seq") mesh (module
    docstring). ``params``: the compute-dtype model; ``batch``: this data
    index's rows; ``count``: the GLOBAL batch's valid labels; ``source``
    (a ``BatchShard`` of the data index's rows, or None: no dropout) draws
    one process's masks. ``reduce=False`` returns this rank's part (seq
    rank 0's summed log-likelihood over ``count``, 0 elsewhere) for the
    backward; ``reduce`` sums the parts over "data" and "seq" (a
    collective, no gradient)."""
    tc = cfg.t5
    rate = tc.dropout_rate
    images, tokens = mprgen._batch_visual(batch, cfg)
    embeds, mask = mprgen.combine_inputs(params, cfg, images,
                                         batch["input_ids"],
                                         batch["text_mask"], tokens)
    # the stack's input dropout on the whole sequence, so that every
    # rank's chunk is cut from one dropped-out tensor
    embeds = dropout(embeds, rate, source)
    b, L, D = embeds.shape
    n = mesh.n_seq
    Lc = -(-L // n)  # ragged lengths get a masked zero tail
    if Lc * n != L:
        pad = Lc * n - L
        embeds = torch.cat([embeds, embeds.new_zeros((b, pad, D))], dim=1)
        mask = torch.cat([mask, mask.new_zeros((b, pad))], dim=1)
    chunk = _chunk(mesh, Lc)
    enc_source = (None if source is None
                  else SeqChunk(source, L, mesh.seq_index, n))
    x = _encode_chunk(params.t5.encoder, tc, embeds[:, chunk],
                      mask[:, chunk], mesh.seq, Lc * n, enc_source)
    hidden = gather_seq(x, mesh)
    labels = batch["labels"]
    logits = t5_decode_train(params.t5, tc, hidden, mask,
                             shift_right(labels, tc), source)
    # the decoder is replicated over "seq": only rank 0's term counts
    keep = 1.0 if mesh.seq_index == 0 else 0.0
    loss = label_nll(logits, labels) * keep / torch.clamp(count, min=1)
    if reduce:
        loss = pm.sum_over(loss.detach(), mesh.batch_axes)
    return loss


def make_train_step_sp(cfg: mprgen.MPRGenConfig, trainable=None,
                       compute=None, *, mesh: pm.Mesh):
    """fn(params, opt_state, batch, lr, gen) -> loss, the signature of
    ``train/step.make_train_step``: the global ``batch``, the replicated
    ``params`` and ``opt_state`` updated in place. The gradients of the
    rank's part (:func:`sp_generative_loss`, ``reduce=False``) and the
    loss are summed over "data" and "seq" in one flat ``all_reduce``
    (``parallel/mesh.merge_grads``); ``gen`` draws one process's dropout
    masks."""
    from multimodalpromptretrieval_tpu_torch.train.step import (
        ComputeCopy,
        backward,
    )

    compute = compute or ComputeCopy()
    ready = []

    def step(params, opt_state, batch, lr, gen=None):
        if not ready:
            ready.append(None)
            if trainable is not None:
                mprgen.set_trainable(params, trainable)
                compute.model = None
        run = mprgen.cast_compute(params, cfg, out=compute.of(params, cfg))
        source = (None if gen is None or cfg.t5.dropout_rate <= 0.0
                  else BatchShard(gen, mesh.index, mesh.n_data))
        loss = sp_generative_loss(run, cfg, pm.shard_batch(batch, mesh),
                                  mesh, torch.sum(batch["labels"] != -100),
                                  source, reduce=False)
        grads = backward(loss, run)
        loss = pm.merge_grads(grads, dict(run.named_parameters()), loss,
                              mesh)
        adamw_update(params, grads, opt_state, lr, trainable=trainable)
        return loss.detach()

    return step


def make_eval_loss_step_sp(cfg: mprgen.MPRGenConfig, compute=None, *,
                           mesh: pm.Mesh):
    """fn(params, batch) -> the global batch's mean loss, without dropout
    (``mprgen.loss_fn`` up to the ring's summation order)."""
    from multimodalpromptretrieval_tpu_torch.train.step import ComputeCopy

    compute = compute or ComputeCopy()

    @torch.no_grad()
    def step(params, batch):
        run = mprgen.cast_compute(params, cfg, out=compute.of(params, cfg))
        return sp_generative_loss(run, cfg, pm.shard_batch(batch, mesh),
                                  mesh, torch.sum(batch["labels"] != -100))

    return step


def make_sp_attention(mesh: pm.Mesh, *, causal: bool = False,
                      scale: Optional[float] = None):
    """fn(q, k, v, bias=None, kv_mask=None) over GLOBAL (B, H, L, Dh)
    tensors (the same on every process): each rank takes its data index's
    rows and its sequence chunk, runs :func:`ring_attention` and the
    global output is gathered (differentiable); ``bias`` (1|B, H, L, L)
    and ``kv_mask`` (B, L) global. Comparable to
    ``ops/attention.multi_head_attention(..., impl="xla")``."""

    def call(q, k, v, bias=None, kv_mask=None):
        B, _, L, _ = q.shape
        b, Lc = B // mesh.n_data, L // mesh.n_seq
        rows, chunk = _rows(mesh, b), _chunk(mesh, Lc)
        if bias is not None and bias.shape[0] > 1:
            bias = bias[rows]
        o = ring_attention(
            q[rows, :, chunk], k[rows, :, chunk], v[rows, :, chunk],
            axis=mesh.seq, bias=bias,
            kv_mask=None if kv_mask is None else kv_mask[rows, chunk],
            causal=causal, scale=scale)
        return gather_global(o, mesh, dim=2)

    return call
