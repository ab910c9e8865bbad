"""Fused L2 distance + top-k retrieval (kernel K4).

Counterpart of ``multimodalpromptretrieval_tpu/ops/topk.py``. Reference
semantics: Euclidean distance of the (B, D) queries to the (N, D) corpus
over RAW embeddings (L2, not cosine: SURVEY quirk #1), ascending, ties to
the lower corpus index; ``skip_first`` drops the nearest match (the
training-phase self-match skip, quirk #3).

Both versions compute the squared distance as ``qsq - 2 * dot + nsq`` in
fp32, rank by it and return ``sqrt(max(d, 0))``, or with ``squared`` the
squared distance itself (what a merge of several top-k lists must compare:
two squared distances can round to one square root). ``l2_topk`` dispatches on the device
only: a CPU tensor takes :func:`l2_topk_reference`, a CUDA tensor launches
``csrc/l2_topk.cu`` or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build


def l2_topk_reference(query: torch.Tensor, index: torch.Tensor, k: int,
                      index_sq: torch.Tensor, squared: bool = False):
    """Plain PyTorch version of the kernel: the k nearest rows, distances
    ascending. A STABLE sort keeps ties in corpus order (``torch.topk``
    does not promise an order among equal values)."""
    q = query.float()
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    sq = q_sq - 2.0 * torch.matmul(q, index.float().t()) + index_sq[None, :]
    d, i = torch.sort(sq, dim=1, stable=True)
    d = d[:, :k]
    return (d if squared else torch.sqrt(torch.clamp(d, min=0.0)),
            i[:, :k].to(torch.int32))


def _l2_topk_cuda(query, index, k, index_sq, squared=False):
    name = "l2_topk"
    _build.require_cuda(name, query, index, index_sq)
    B, D = query.shape
    N = index.shape[0]
    lib = _build.library()
    if not 1 <= k <= N:
        raise ValueError(f"{name}: k={k} outside 1..{N}")
    if index.shape[1] != D or tuple(index_sq.shape) != (N,):
        raise ValueError(f"{name}: index {tuple(index.shape)} / index_sq "
                         f"{tuple(index_sq.shape)} do not match D={D}")
    for t in (query, index, index_sq):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: inputs must be contiguous fp32")
    scratch = torch.empty(B * lib.mpr_l2_topk_scratch_cols(N),
                          dtype=torch.float32, device=query.device)
    out_d = torch.empty((B, k), dtype=torch.float32, device=query.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=query.device)
    code = lib.mpr_l2_topk(
        query.data_ptr(), index.data_ptr(), index_sq.data_ptr(), B, N, D, k,
        scratch.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), int(squared),
        _build.stream_handle(query))
    _build.check(code, name)
    _build.count_launch(name)
    return out_d, out_i


def l2_topk(query: torch.Tensor, index: torch.Tensor, k: int, *,
            index_sq: Optional[torch.Tensor] = None,
            skip_first: bool = False, squared: bool = False):
    """Top-k nearest corpus rows by Euclidean distance.

    query (B, D), index (N, D); ``index_sq`` optional precomputed (N,)
    squared row norms. Returns (distances (B, k) ascending, or squared
    distances with ``squared``, indices (B, k) int32)."""
    fetch = k + 1 if skip_first else k
    query = query.float().contiguous()
    if index_sq is None:
        index_sq = torch.sum(torch.square(index.float()), dim=-1)
    if query.device.type == "cpu":
        d, i = l2_topk_reference(query, index, fetch, index_sq, squared)
    else:
        d, i = _l2_topk_cuda(query, index, fetch, index_sq, squared)
    if skip_first:
        d, i = d[:, 1:], i[:, 1:]
    return d, i
