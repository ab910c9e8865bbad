"""The ``parallelism`` config key, the mesh of processes, and what the
parallel steps collect: data parallelism, Megatron tensor parallelism over
"model", the parameter layout of pipeline parallelism over "pipe", and the
"seq" axis of sequence parallelism.

Counterpart of ``multimodalpromptretrieval_tpu/parallel/mesh.py`` (the
data-parallel half and the Megatron rules ``_spec_for_path`` /
``param_shardings`` / ``shard_params``), of the JAX ``_pp_tp_spec`` of
``parallel/pipeline.py``, of ``get_seq_mesh`` of ``parallel/sequence.py``
and of the JAX ``Experiment._build_mesh``. The mesh has the axes "data",
"pipe", "model" and "seq", "seq" innermost and then "model": process
``rank = ((d * n_pipe + p) * n_model + m) * n_seq + s``, the JAX device
order of ``get_mesh`` / ``get_pipe_mesh`` / ``get_seq_mesh`` ("seq"
composes only with "data", so under it ``rank = d * n_seq + s``). Every
process holds the same host batch and its data index takes its contiguous
block of rows (``P("data")``).

  * data: the steps of ``train/step.py`` weight each data shard's loss by
    its share of the global batch's valid targets and sum the gradients
    and that loss in ONE flat fp32 ``all_reduce`` over "data" a step;
    dropout masks are drawn at the global batch's shape and each data
    index keeps its rows (``ops.layers.BatchShard``); predict gathers the
    rows in order; the server (``serve.py``) splits each chunk's rows;
  * model (Megatron TP, ``param_spec``): each T5 attention's packed
    ``qkv`` keeps the rows of the rank's ``H / n_model`` heads from each of
    its q, k, v blocks, ``ff.wi`` / ``wi_0`` / ``wi_1`` split over their
    output features, ``o`` / ``ff.wo`` over their input features, and the
    rest is replicated. :func:`copy_to_model` (identity forward,
    ``all_reduce`` of the gradient backward) enters each column-split
    product and :func:`reduce_from_model` (``all_reduce`` forward,
    identity backward) leaves each row-split one, so the residual stream,
    the loss and every replicated gradient are whole on every model rank;
  * pipe: stage ``p`` holds layers ``[p * L / S, (p + 1) * L / S)`` of both
    T5 stacks (``parallel/pipeline.py``); under TP x PP the ``rel_bias``
    tables also split over their heads, as ``_pp_tp_spec`` does;
  * seq (``parallel/sequence.py``): the parameters are replicated; seq
    rank ``s`` runs the T5 encoder on the ``s``-th contiguous chunk of the
    sequence, its attention a ring over the axis (``seq.pairs``: the
    two-process group of each neighbour pair).

A rank's gradient is summed over every axis along which it is partial
(:func:`partial_axes`, the JAX ``merge`` rule): "pipe" for the leaves every
stage holds, "model" for a replicated ``rel_bias`` (each rank reads its
heads' columns), "data" and "seq" for all (one ``all_reduce`` over both:
under "seq" they span every process). :func:`gather_params` /
:func:`shard_params` move parameters between a rank's layout and the
one-process layout, bit for bit. Quantities a head variant takes over the
whole batch (the longest prompt) are read from the global batch before it
is split.
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from multimodalpromptretrieval_tpu_torch.parallel import multihost


class Axis:
    """One mesh axis as this process sees it: its ``size``, this process's
    ``index`` along it, and ``group``, the process group of the processes
    that differ from this one along this axis only (None: the default
    group, or no group when ``size`` is 1). ``ranks``: the global ranks
    along the axis, in order (set for "pipe" and "seq", whose hops name
    their source); ``pairs``: pair ``i`` -> the two-process group of
    positions ``i`` and ``i + 1`` (this process's pairs: the pipeline's
    neighbours, and the "seq" ring's, mod ``size``)."""

    def __init__(self, size: int, index: int, group=None):
        self.size, self.index, self.group = size, index, group
        self.ranks: List[int] = []
        self.pairs: Dict[int, Any] = {}


def pair_broadcast(x: torch.Tensor, axis: Axis, pair: int,
                   src: int) -> None:
    """One hop between neighbours of ``axis``: ``x`` broadcast from its
    position ``src`` over the two-process group ``axis.pairs[pair]`` (the
    sender's ``x`` is sent, the receiver's overwritten; NCCL and gloo's
    CUDA backend both have ``broadcast``)."""
    dist.broadcast(x, src=axis.ranks[src], group=axis.pairs[pair])


class Mesh:
    """The ("data", "pipe", "model", "seq") mesh over ``n_data * n_pipe *
    n_model * n_seq`` processes, this one at ``rank`` (default: its rank in
    the default group when the mesh has more than one process). ``data``,
    ``pipe``, ``model`` and ``seq`` are this process's :class:`Axis` of
    each; ``index`` (the data index), ``stage``, ``model_index`` and
    ``seq_index`` its coordinates; ``world`` its process count. The groups
    are made by :meth:`make_groups`."""

    def __init__(self, n_data: int = 1, n_pipe: int = 1, n_model: int = 1,
                 rank: Optional[int] = None, *, n_seq: int = 1):
        self.n_data, self.n_pipe, self.n_model = n_data, n_pipe, n_model
        self.n_seq = n_seq
        self.world = n_data * n_pipe * n_model * n_seq
        if rank is None:
            rank = multihost.process_index() if self.world > 1 else 0
        self.rank = rank
        self.index, rest = divmod(rank, n_pipe * n_model * n_seq)
        self.stage, rest = divmod(rest, n_model * n_seq)
        self.model_index, self.seq_index = divmod(rest, n_seq)
        self.data = Axis(n_data, self.index)
        self.pipe = Axis(n_pipe, self.stage)
        self.model = Axis(n_model, self.model_index)
        self.seq = Axis(n_seq, self.seq_index)
        self.pipe.ranks = [self.rank_of(self.index, p, self.model_index,
                                        self.seq_index)
                           for p in range(n_pipe)]
        self.seq.ranks = [self.rank_of(self.index, self.stage,
                                       self.model_index, s)
                          for s in range(n_seq)]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model,
                "pipe": self.n_pipe, "seq": self.n_seq}

    def rank_of(self, d: int, p: int, m: int, s: int = 0) -> int:
        return ((d * self.n_pipe + p) * self.n_model + m) * self.n_seq + s

    @property
    def batch_axes(self) -> Axis:
        """"data" and "seq" as one axis: the processes that share this
        one's stage and model rank (every process under "seq", which
        composes only with "data")."""
        axis = Axis(self.n_data * self.n_seq,
                    self.index * self.n_seq + self.seq_index)
        if self.n_seq == 1:
            axis.group = self.data.group
        return axis

    def unpipelined(self) -> "Mesh":
        """This mesh as the layout functions see the un-pipelined
        parameters (the predict after a pipelined train): "pipe" 1 wide,
        every stage holding every layer; the processes, this one's stage
        and the "data" / "model" axes and groups are this mesh's."""
        view = copy.copy(self)
        view.n_pipe, view.pipe = 1, Axis(1, 0)
        return view

    def make_groups(self) -> None:
        """The sub-groups, made in one order on every process (each process
        of the default group must call this): the "model" group of each
        (d, p), the "pipe" group of each (d, m) and its neighbour pairs,
        the "seq" group of each data index and its ring pairs, the "data"
        group of each (p, m, s). An axis over every process uses the
        default group; an axis of size 1 has none."""
        D, S, M, Q = self.n_data, self.n_pipe, self.n_model, self.n_seq

        def make(ranks: List[int]):
            if len(ranks) == self.world:
                return None
            group = dist.new_group(ranks)
            return group if self.rank in ranks else False

        def mine(axis: Axis, group) -> None:
            if group is not False:
                axis.group = group

        if M > 1:
            for d in range(D):
                for p in range(S):
                    mine(self.model, make([self.rank_of(d, p, m)
                                           for m in range(M)]))
        if S > 1:
            for d in range(D):
                for m in range(M):
                    ranks = [self.rank_of(d, p, m) for p in range(S)]
                    group = make(ranks)
                    mine(self.pipe, group)
                    for p in range(S - 1):
                        pair = group if S == 2 else make(ranks[p:p + 2])
                        if pair is not False and self.rank in ranks[p:p + 2]:
                            self.pipe.pairs[p] = pair
        if Q > 1:
            # "seq" composes only with "data" (build_mesh): S = M = 1
            for d in range(D):
                ranks = [self.rank_of(d, 0, 0, s) for s in range(Q)]
                group = make(ranks)
                mine(self.seq, group)
                for i in range(Q):
                    pair = ranks[i], ranks[(i + 1) % Q]
                    group_i = group if Q == 2 else make(list(pair))
                    if group_i is not False and self.rank in pair:
                        self.seq.pairs[i] = group_i
        if D > 1:
            for p in range(S):
                for m in range(M):
                    for s in range(Q):
                        mine(self.data, make([self.rank_of(d, p, m, s)
                                              for d in range(D)]))


def build_mesh(cfg: Dict[str, Any]) -> Mesh:
    """The mesh of the config's ``parallelism`` key over the processes of
    the default group (1 without one), with the JAX ``_build_mesh`` checks
    and messages in its order: "seq" with "model" or "pipe", a width that
    does not divide the processes, an explicit "data" that does not divide
    ``batch_size``, data * width above the processes. "data" defaults to
    the processes left, shrunk until it divides ``batch_size``. Then a
    mesh that leaves processes out (the JAX package's idle devices) raises
    ``ValueError`` naming the shrink. With a process group, every process
    must call this (it makes the sub-groups)."""
    par = dict(cfg.get("parallelism") or {})
    n_model = int(par.get("model", 1))
    n_pipe = int(par.get("pipe", 1))
    n_seq = int(par.get("seq", 1))
    if n_seq > 1 and (n_model > 1 or n_pipe > 1):
        raise ValueError(
            "parallelism: 'seq' composes only with 'data' — combined "
            "seq+model/pipe meshes are not supported (model+pipe IS: "
            "set both 'model' and 'pipe' above 1 for TP x PP)")
    n_dev = multihost.process_count()
    width = n_model * n_pipe * n_seq
    if n_dev % width:
        raise ValueError(
            f"parallelism: model*pipe*seq = {width} does not divide "
            f"the {n_dev} available devices")
    bs = cfg["hyperparameters"]["batch_size"]
    explicit = int(par.get("data", 0))
    if explicit and bs % explicit:
        raise ValueError(
            f"parallelism: data={explicit} does not divide "
            f"batch_size={bs}")
    n = explicit or n_dev // width
    while n > 1 and bs % n:
        n -= 1
    if n * width > n_dev:
        raise ValueError(
            f"parallelism: data={n} * model*pipe*seq={width} exceeds "
            f"the {n_dev} available devices")
    if n * width < n_dev:
        raise ValueError(
            f"parallelism: data={n} (batch_size={bs}) uses {n * width} of "
            f"the {n_dev} processes; the port runs over every process of "
            "the group (make batch_size a multiple of the data axis, or "
            "start fewer processes)")
    mesh = Mesh(n, n_pipe, n_model, n_seq=n_seq)
    if mesh.world > 1 and dist.is_initialized():
        mesh.make_groups()
    return mesh


def check_model_split(cfg, n_model: int) -> None:
    """The heads and ``d_ff`` of a ``T5Config`` split over "model" (the
    JAX pipeline step's check and message)."""
    if cfg.num_heads % n_model or cfg.d_ff % n_model:
        raise ValueError(f"heads={cfg.num_heads}/d_ff={cfg.d_ff} don't "
                         f"shard over model={n_model}")


def tp_axis(mesh: Optional[Mesh]) -> Optional[Axis]:
    """The "model" axis of ``mesh`` when it is wider than 1, else None."""
    return mesh.model if mesh is not None and mesh.n_model > 1 else None


# ---------------------------------------------------------------------------
# Megatron operators
# ---------------------------------------------------------------------------


def _sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis`` in fp32, in ``x``'s dtype (a new
    tensor)."""
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    y.copy_(x)
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum_over(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Megatron's f, entering the model region: identity forward, the
    input gradient summed over ``axis`` backward. Identity without one."""
    if axis is None or axis.size == 1:
        return x
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor,
                      axis: Optional[Axis]) -> torch.Tensor:
    """Megatron's g, leaving the model region: the partial outputs summed
    over ``axis`` (in fp32) forward, identity backward."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromModel.apply(x, axis)


# ---------------------------------------------------------------------------
# The parameter layout
# ---------------------------------------------------------------------------

_BLOCK = re.compile(r"t5\.(encoder|decoder)\.block\.(\d+)\.(.+)")
_COLUMN = ("wi", "wi_0", "wi_1")
_ROW = ("o", "wo")


def param_spec(name: str, n_pipe: int = 1,
               n_model: int = 1) -> Tuple[bool, Optional[str]]:
    """(split over "pipe", split over "model") of parameter ``name``: the
    first True for a T5 block's leaves when ``n_pipe > 1``; the second
    ``"qkv"`` (each of q, k, v keeps its heads' rows), ``"out"`` (torch dim
    0, the output features), ``"in"`` (dim 1, the input features) or
    ``"heads"`` (a ``rel_bias`` table's columns, under TP x PP only) when
    ``n_model > 1``, else None (replicated)."""
    block = _BLOCK.fullmatch(name)
    kind = None
    if n_model > 1:
        parts = name.split(".")
        if block is not None:
            if parts[-1] == "qkv":
                kind = "qkv"
            elif parts[-2] in _COLUMN:
                kind = "out"
            elif parts[-2] in _ROW:
                kind = "in"
        elif n_pipe > 1 and name in ("t5.encoder.rel_bias",
                                     "t5.decoder.rel_bias"):
            kind = "heads"
    return block is not None and n_pipe > 1, kind


def partial_axes(name: str, mesh: Mesh) -> Tuple[bool, bool]:
    """(partial over "pipe", partial over "model") of a rank's gradient of
    ``name``: over "pipe" every leaf that each stage holds whole; over
    "model" a ``rel_bias`` that stays replicated (each rank's gradient
    covers its own heads' columns). Under the Megatron operators every
    other replicated leaf's gradient is whole on each model rank. Every
    gradient is partial over "data" and "seq" (each seq rank's covers its
    chunk of the sequence: the JAX ``psum(psum(g, "seq"), "data")``)."""
    split_pipe, kind = param_spec(name, mesh.n_pipe, mesh.n_model)
    return (mesh.n_pipe > 1 and not split_pipe,
            mesh.n_model > 1 and kind is None and name.endswith("rel_bias"))


def _take(full: torch.Tensor, kind: Optional[str], index: int,
          count: int) -> torch.Tensor:
    """Model rank ``index``'s piece of ``full`` (a view)."""
    if kind is None:
        return full
    if kind == "qkv":
        third = full.shape[0] // 3
        w = third // count
        return torch.cat([full[j * third + index * w:
                               j * third + (index + 1) * w]
                          for j in range(3)])
    dim = 0 if kind == "out" else 1
    w = full.shape[dim] // count
    return full.narrow(dim, index * w, w)


def _place(full: torch.Tensor, piece: torch.Tensor, kind: Optional[str],
           index: int, count: int) -> None:
    """Write model rank ``index``'s ``piece`` into ``full``."""
    if kind == "qkv":
        third, w = full.shape[0] // 3, piece.shape[0] // 3
        for j in range(3):
            full[j * third + index * w:j * third + (index + 1) * w] = \
                piece[j * w:(j + 1) * w]
    else:
        _take(full, kind, index, count).copy_(piece)


def _full_shape(shape, kind: Optional[str], count: int) -> Tuple[int, ...]:
    shape = list(shape)
    if kind is not None:
        shape[0 if kind in ("qkv", "out") else 1] *= count
    return tuple(shape)


def _layers(cfg) -> Dict[str, int]:
    return {"encoder": cfg.num_layers, "decoder": cfg.num_decoder_layers}


def shard_tensors(full: Dict[str, torch.Tensor], cfg,
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's pieces of one-process tensors by name (parameters or
    AdamW moments; ``cfg`` the ``T5Config``), under its local names: the
    stage's blocks renumbered from 0, each model-split leaf cut to the
    rank's piece (new tensors; the rest are ``full``'s)."""
    n_pipe = mesh.n_pipe
    layers = _layers(cfg)
    out = {}
    for name, t in full.items():
        split_pipe, kind = param_spec(name, n_pipe, mesh.n_model)
        if split_pipe:
            stack, i, rest = _BLOCK.fullmatch(name).groups()
            per = layers[stack] // n_pipe
            if int(i) // per != mesh.stage:
                continue
            name = f"t5.{stack}.block.{int(i) - mesh.stage * per}.{rest}"
        out[name] = (_take(t, kind, mesh.model_index, mesh.n_model).clone()
                     if kind else t)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bits of ``t`` as int32, one element each (4- or 2-byte
    dtypes)."""
    t = t.contiguous()
    if t.element_size() == 4:
        return t.view(torch.int32)
    return t.view(torch.int16).to(torch.int32)


def _from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if torch.empty((), dtype=dtype).element_size() == 4:
        return b.view(dtype)
    return b.to(torch.int16).view(dtype)


def gather_tensors(local: Dict[str, torch.Tensor], cfg,
                   mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_tensors`: every tensor in the one-process
    layout, on every process (a collective: all processes of the mesh
    call it). The leaves every rank holds whole are its own; the split
    ones are the sum over all processes of their bits, each element put
    in by exactly one rank (data index 0, model rank 0 for a leaf the
    model ranks share, stage 0 for a leaf every stage holds), so the
    result is bit for bit the pieces."""
    n_pipe = mesh.n_pipe
    out: Dict[str, torch.Tensor] = {}
    # (name, kind, owning stage, local tensor or None, full shape, dtype)
    split = []
    firsts: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    for name, t in local.items():
        block = _BLOCK.fullmatch(name)
        if n_pipe > 1 and block is not None:
            stack, i, rest = block.groups()
            if i == "0":
                firsts.setdefault(stack, []).append((rest, t))
            continue
        kind = param_spec(name, n_pipe, mesh.n_model)[1]
        if kind is None:
            out[name] = t
        else:
            # held by every stage: stage 0's copy counts
            split.append((name, kind, 0, t,
                          _full_shape(t.shape, kind, mesh.n_model), t.dtype))
    for stack, n in _layers(cfg).items() if n_pipe > 1 else ():
        per = n // n_pipe
        for i in range(n):
            owner = i // per
            for rest, t0 in firsts.get(stack, ()):
                name = f"t5.{stack}.block.{i}.{rest}"
                kind = param_spec(name, n_pipe, mesh.n_model)[1]
                mine = None
                if owner == mesh.stage:
                    mine = local[f"t5.{stack}.block.{i - owner * per}.{rest}"]
                split.append((name, kind, owner, mine,
                              _full_shape(t0.shape, kind, mesh.n_model),
                              t0.dtype))
    if not split:
        return out
    device = next(iter(local.values())).device
    sizes = [torch.Size(shape).numel() for _, _, _, _, shape, _ in split]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    at = 0
    for (name, kind, owner, mine, shape, _), size in zip(split, sizes):
        if (mine is not None and owner == mesh.stage and mesh.index == 0
                and (kind is not None or mesh.model_index == 0)):
            _place(flat[at:at + size].view(shape), _bits(mine.detach()),
                   kind, mesh.model_index, mesh.n_model)
        at += size
    if mesh.world > 1:
        dist.all_reduce(flat)
    at = 0
    for (name, _, _, _, shape, dtype), size in zip(split, sizes):
        out[name] = _from_bits(flat[at:at + size].view(shape), dtype)
        at += size
    return out


def _set_param(module: nn.Module, name: str, t: torch.Tensor,
               requires_grad: bool) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner), leaf,
            nn.Parameter(t, requires_grad=requires_grad))


def _stacks(params: nn.Module):
    return (("encoder", params.t5.encoder), ("decoder", params.t5.decoder))


def shard_params(full: nn.Module, cfg, mesh: Mesh) -> nn.Module:
    """This process's parameters (a new module; ``cfg`` the
    ``MPRGenConfig``): the stage's blocks (``n_pipe > 1``) and the rank's
    pieces of the model-split leaves. ``mesh.unpipelined()`` gives the
    layout of the un-pipelined predict."""
    local = copy.deepcopy(full)
    n_pipe = mesh.n_pipe
    if n_pipe > 1:
        for stack, mod in _stacks(local):
            per = _layers(cfg.t5)[stack] // n_pipe
            mod.block = nn.ModuleList(
                list(mod.block)[mesh.stage * per:(mesh.stage + 1) * per])
    for name, p in list(local.named_parameters()):
        kind = param_spec(name, n_pipe, mesh.n_model)[1]
        if kind is not None:
            _set_param(local, name, _take(p.detach(), kind,
                                          mesh.model_index,
                                          mesh.n_model).clone(),
                       p.requires_grad)
    return local


def gather_params(local: nn.Module, cfg, mesh: Mesh) -> nn.Module:
    """The inverse of :func:`shard_params` (a collective): the one-process
    module, bit for bit, on every process."""
    full = copy.deepcopy(local)
    n_pipe = mesh.n_pipe
    if n_pipe > 1:
        from multimodalpromptretrieval_tpu_torch.models.t5 import (
            T5DecoderLayer,
            T5EncoderLayer,
        )

        device = next(local.parameters()).device
        for (stack, mod), layer in zip(_stacks(full), (T5EncoderLayer,
                                                       T5DecoderLayer)):
            mod.block = nn.ModuleList(
                layer(cfg.t5, None) for _ in range(_layers(cfg.t5)[stack]))
            mod.block.to(device)
    flags = {n: p.requires_grad for n, p in local.named_parameters()}
    for name, t in gather_tensors(dict(local.named_parameters()), cfg.t5,
                                  mesh).items():
        split_pipe, kind = param_spec(name, n_pipe, mesh.n_model)
        if split_pipe or kind is not None:
            block = _BLOCK.fullmatch(name)
            flag = flags[name] if block is None else flags[
                f"t5.{block.group(1)}.block.0.{block.group(3)}"]
            _set_param(full, name, t.detach(), flag)
    return full


def shard_state(state: Dict[str, Any], cfg, mesh: Mesh) -> Dict[str, Any]:
    """An AdamW state of one process's layout in this process's."""
    return {"mu": shard_tensors(state["mu"], cfg.t5, mesh),
            "nu": shard_tensors(state["nu"], cfg.t5, mesh),
            "step": state["step"]}


def gather_state(state: Dict[str, Any], cfg, mesh: Mesh) -> Dict[str, Any]:
    """The inverse of :func:`shard_state` (a collective)."""
    return {"mu": gather_tensors(state["mu"], cfg.t5, mesh),
            "nu": gather_tensors(state["nu"], cfg.t5, mesh),
            "step": state["step"]}


def shard_batch(batch: Dict[str, torch.Tensor],
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This process's contiguous block of every batch array's rows (views,
    no copies). A batch with a ``text_mask`` also gets ``longest``, the
    global batch's longest prompt, which the head variants read."""
    n = next(iter(batch.values())).shape[0]
    if n % mesh.n_data:
        raise ValueError(f"batch of {n} rows does not split over "
                         f"data={mesh.n_data}")
    b = n // mesh.n_data
    rows = slice(mesh.index * b, (mesh.index + 1) * b)
    local = {k: v[rows] for k, v in batch.items()}
    if "text_mask" in batch:
        local["longest"] = torch.amax(torch.sum(batch["text_mask"], dim=1))
    return local


def loss_weight(cfg, batch: Dict[str, torch.Tensor],
                local: Dict[str, torch.Tensor]) -> torch.Tensor:
    """This process's share of the global batch's valid targets (answer
    tokens, or labelled rows for the head variants): its mean loss times
    this is its part of the global mean. A device scalar, no sync."""
    def count(b):
        if cfg.use_prediction_head:
            return torch.sum(b["class_labels"] >= 0)
        return torch.sum(b["labels"] != -100)

    return (count(local).float()
            / torch.clamp(count(batch), min=1).float())


def _flat_sum(grads: Dict[str, Optional[torch.Tensor]], names: List[str],
              like: Dict[str, torch.Tensor], loss: Optional[torch.Tensor],
              axis: Axis) -> Optional[torch.Tensor]:
    """Sum ``grads[n]`` for ``names`` (zeros shaped as ``like[n]`` where
    None) and ``loss`` over ``axis`` in ONE fp32 ``all_reduce``; the
    entries become views of the sum. Returns the summed loss."""
    parts = [grads[n].detach().float().reshape(-1)
             if grads.get(n) is not None else
             torch.zeros(like[n].numel(), device=like[n].device)
             for n in names]
    if loss is not None:
        parts.append(loss.detach().float().reshape(1))
    if not parts:
        return loss
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=axis.group)
    at = 0
    for n in names:
        size = like[n].numel()
        grads[n] = flat[at:at + size].view(like[n].shape)
        at += size
    return flat[-1] if loss is not None else None


def merge_grads(grads: Dict[str, Optional[torch.Tensor]],
                like: Dict[str, torch.Tensor], loss: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """Sum each gradient of ``grads`` (this rank's, by its local names;
    ``like`` the parameters, for shapes) over the axes along which it is
    partial (:func:`partial_axes`): "pipe", with ``loss`` (a stage's
    part), then "model", then every entry and ``loss`` over "data" and
    "seq" together (:attr:`Mesh.batch_axes`). One flat fp32 ``all_reduce``
    an axis; the entries become fp32 views of the sums. Returns the summed
    loss. A group of one process still takes the (identity) data
    ``all_reduce``: its step is the plain step through the collective."""
    names = list(grads)
    if mesh.n_pipe > 1:
        loss = _flat_sum(grads, [n for n in names
                                 if partial_axes(n, mesh)[0]],
                         like, loss, mesh.pipe)
    if mesh.n_model > 1:
        _flat_sum(grads, [n for n in names
                          if partial_axes(n, mesh)[1]],
                  like, None, mesh.model)
    if (mesh.n_data * mesh.n_seq > 1
            or (mesh.world == 1 and dist.is_initialized())):
        loss = _flat_sum(grads, names, like, loss, mesh.batch_axes)
    return loss


def sum_over(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis`` (a new tensor; ``x`` itself when the
    axis is 1 wide)."""
    if axis.size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=axis.group)
    return x


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data index's ``x`` stacked in order, (n_data, *x.shape): the
    all_reduce over "data" of zero-filled buffers (gloo's CUDA backend has
    no all_gather)."""
    if mesh.n_data == 1:
        return x[None]
    buf = torch.zeros((mesh.n_data,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[mesh.index] = x
    dist.all_reduce(buf, group=mesh.data.group)
    return buf


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch's rows of a per-process output, in row order."""
    return gather(x, mesh).reshape((-1,) + tuple(x.shape[1:]))


def gather_bits(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:func:`gather` bit for bit (4- and 2-byte dtypes): the sum of the
    zero-filled buffers of ``x``'s bits, as :func:`gather_tensors` sums
    them (a float sum turns -0.0 into +0.0)."""
    if mesh.n_data == 1:
        return x[None]
    return _from_bits(gather(_bits(x), mesh), x.dtype)
