"""Index-sharded retrieval: a local top-k per process, then a merge.

Counterpart of ``multimodalpromptretrieval_tpu/parallel/retrieval.py``. The
(N, D) fp32 index is padded to a multiple of the process count and split
into contiguous row blocks; each process runs the L2 top-k kernel (K4,
``ops/topk.l2_topk``) over its block, the candidates with their global row
numbers and SQUARED distances are gathered (an ``all_reduce`` of
zero-filled buffers), and :func:`merge_candidates` keeps the overall top-k.
The ranking is the single-index kernel's: squared distances ascending, ties
to the lower corpus row; the square roots are taken after the merge (two
squared distances can round to one root, and only the squares order them
as the kernel did).
"""

from __future__ import annotations

import torch

from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk
from multimodalpromptretrieval_tpu_torch.parallel import mesh as pmesh

# the squared norm of a padded row: no real row is that far from a query
_BIG = 3.4e38


def pad_index_for_mesh(index: torch.Tensor, mesh: pmesh.Mesh):
    """(this process's row block of the index padded to a multiple of
    ``mesh.n_data`` rows, the number of real rows N)."""
    n = index.shape[0]
    rows = -(-n // mesh.n_data)
    block = index[mesh.index * rows:(mesh.index + 1) * rows]
    pad = rows - block.shape[0]
    if pad:
        block = torch.cat([block, block.new_zeros((pad, index.shape[1]))])
    return block.contiguous(), n


def local_topk(query: torch.Tensor, block: torch.Tensor, shard: int,
               n_valid: int, fetch: int):
    """The ``min(fetch, rows)`` nearest rows of block number ``shard`` by
    K4: (SQUARED distances, GLOBAL row numbers), padded rows (global row >=
    ``n_valid``) pushed past every real one."""
    rows = block.shape[0]
    base = shard * rows
    sq = torch.sum(torch.square(block.float()), dim=-1)
    ids = base + torch.arange(rows, device=block.device)
    sq = torch.where(ids < n_valid, sq, _BIG)
    d, i = l2_topk(query, block, min(fetch, rows), index_sq=sq, squared=True)
    return d, i + base


def merge_candidates(cand_d: torch.Tensor, cand_i: torch.Tensor,
                     fetch: int):
    """Merge per-shard candidates (n_shards, B, f) into the top ``fetch``
    per query: sorted by global row, then stably by (squared) distance, so
    equal distances keep the lower row first."""
    S, B, f = cand_d.shape
    d = cand_d.permute(1, 0, 2).reshape(B, S * f)
    i = cand_i.permute(1, 0, 2).reshape(B, S * f)
    by_row = torch.argsort(i, dim=1, stable=True)
    d, i = torch.gather(d, 1, by_row), torch.gather(i, 1, by_row)
    final = torch.argsort(d, dim=1, stable=True)[:, :fetch]
    return torch.gather(d, 1, final), torch.gather(i, 1, final)


def sharded_l2_topk(query: torch.Tensor, block: torch.Tensor, n_valid: int,
                    k: int, *, mesh: pmesh.Mesh,
                    skip_first: bool = False):
    """Top-k nearest rows by L2 over a row-sharded index.

    query (B, D), the same on every process; ``block`` this process's rows
    (:func:`pad_index_for_mesh`). Returns (distances (B, k), global row
    numbers (B, k) int32), the ranking of ``ops.topk.l2_topk`` on the whole
    index; ``skip_first`` drops the nearest match."""
    fetch = k + 1 if skip_first else k
    d, i = local_topk(query, block, mesh.index, n_valid, fetch)
    d, i = merge_candidates(pmesh.gather(d, mesh), pmesh.gather(i, mesh),
                            fetch)
    if skip_first:
        d, i = d[:, 1:], i[:, 1:]
    return torch.sqrt(torch.clamp(d, min=0.0)), i.to(torch.int32)
