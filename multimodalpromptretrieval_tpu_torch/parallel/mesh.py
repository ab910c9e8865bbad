"""Data parallelism over the process group: the ``parallelism`` config key,
the mesh, batch sharding, and what the data-parallel steps collect.

Counterpart of the data-parallel half of
``multimodalpromptretrieval_tpu/parallel/mesh.py`` and of the JAX
``Experiment._build_mesh``. Data parallelism is the first-class strategy:
parameters and the optimizer state are replicated, every process holds the
same host batch and takes its own contiguous block of rows (``P("data")``),
and the steps of ``train/step.py``, built with ``mesh=``, add the
collectives:

  * train: each process's loss is weighted by its share of the global
    batch's valid targets (tokens, or rows for the head variants), so the
    sum over processes is the mean over the whole batch, as one process
    computes it; the gradients and that loss go in ONE flat fp32 buffer,
    summed by one ``all_reduce`` a step; AdamW then runs identically on
    every process. Dropout masks are drawn at the global batch's shape and
    each process keeps its rows (``ops.layers.BatchShard``);
  * eval loss: the weighted losses, summed;
  * predict: each process's rows, gathered in row order.

Quantities a head variant takes over the whole batch (the longest prompt)
are read from the global batch before it is split. Tensor, pipeline and
sequence parallelism are later slices: a ``parallelism`` key that asks for
them raises ``NotImplementedError`` (ROADMAP A8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from multimodalpromptretrieval_tpu_torch.parallel import multihost


class DataMesh:
    """The "data" axis: ``n_data`` processes of the default group (every
    process of it when ``n_data > 1``), this one at ``index`` (default:
    its rank). The other axes ("model", "pipe", "seq") are 1."""

    def __init__(self, n_data: int, index: Optional[int] = None):
        self.n_data = n_data
        if index is None:
            index = multihost.process_index() if n_data > 1 else 0
        self.index = index

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": 1, "pipe": 1, "seq": 1}


def build_mesh(cfg: Dict[str, Any]) -> DataMesh:
    """The mesh of the config's ``parallelism`` key over the processes of
    the default group (1 without one), with the JAX ``_build_mesh`` checks
    and messages in its order: "seq" with "model" or "pipe", a width that
    does not divide the processes, an explicit "data" that does not divide
    ``batch_size``, data * width above the processes. "data" defaults to
    the processes left, shrunk until it divides ``batch_size``. A mesh that
    leaves processes out (the JAX package's idle devices) raises
    ``ValueError`` naming the shrink; "model", "pipe" or "seq" above 1
    raise ``NotImplementedError``."""
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
    if width > 1:
        raise NotImplementedError(
            f"parallelism: model={n_model}, pipe={n_pipe}, seq={n_seq}: "
            "only data parallelism is ported (tensor, pipeline and "
            "sequence parallelism: ROADMAP A8)")
    if n < n_dev:
        raise ValueError(
            f"parallelism: data={n} (batch_size={bs}) uses {n} of the "
            f"{n_dev} processes; the port runs data parallelism over every "
            "process of the group (make batch_size a multiple of the "
            "process count, or start fewer processes)")
    return DataMesh(n)


def shard_batch(batch: Dict[str, torch.Tensor],
                mesh: DataMesh) -> Dict[str, torch.Tensor]:
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


def all_reduce_grads(grads: Dict[str, Optional[torch.Tensor]],
                     loss: torch.Tensor) -> torch.Tensor:
    """Sum ``grads`` (in place: the entries become fp32 views of one flat
    buffer) and ``loss`` over the group with one ``all_reduce``; returns
    the summed loss."""
    names = [n for n, g in grads.items() if g is not None]
    flat = torch.cat([grads[n].detach().float().reshape(-1) for n in names]
                     + [loss.detach().float().reshape(1)])
    dist.all_reduce(flat)
    at = 0
    for n in names:
        size = grads[n].numel()
        grads[n] = flat[at:at + size].view(grads[n].shape)
        at += size
    return flat[-1]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x)
    return x


def gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every process's ``x`` stacked in rank order, (n_data, *x.shape): the
    all_reduce of zero-filled buffers (gloo's CUDA backend has no
    all_gather)."""
    buf = torch.zeros((mesh.n_data,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[mesh.index] = x
    dist.all_reduce(buf)
    return buf


def gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The global batch's rows of a per-process output, in row order."""
    return gather(x, mesh).reshape((-1,) + tuple(x.shape[1:]))
