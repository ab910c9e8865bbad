"""Routed experts: the router and the grouped expert products of a
DeepSeek-V3-style mixture-of-experts layer (the LM generator,
``models/moe_lm.py``).

Replaces no TPU kernel: the JAX package has no expert layer. The port
added it for the Kimi-VL-A3B language model (64 routed experts of width
1,408, 6 a token, 2 shared).

* :func:`route`: sigmoid scores over the experts in fp32, the top k by
  score plus the correction bias (``noaux_tc`` with one group), the
  chosen scores normalised to sum 1 and scaled by
  ``routed_scaling_factor``. Plain torch on every device (a handful of
  small ops).
* :func:`moe_experts`: ``sum_i w_i E_i(h)`` over each token's k experts,
  ``E(h) = W_down(silu(W_gate h) * W_up h)``. A CPU tensor takes
  :func:`moe_experts_reference`, a loop over the experts. A CUDA tensor
  takes K10, two grouped GEMM kernels in CUDA C++
  (``csrc/moe_experts.cu``), over a tiled layout built on the device
  (:func:`tile_rows`): the (token, slot) rows sorted by expert
  (``torch.sort``, stable), each expert's run padded to whole tiles of
  ``block_m`` rows, the experts' ends found by ``searchsorted`` and each
  tile's expert with them, the grid sized from the shapes. No host read
  of the counts, no Python loop over the experts: the first kernel
  gathers each tile's token rows and runs the expert's gate and up
  products and the SiLU product, the second the down product, weighted,
  each row written back once to its (token, slot) place in fp32; the k
  rows of a token are then summed in a fixed order (no atomics).

What bounds it on the H100: at prefill (58,368 tokens x 6 rows over 64
experts, ~5,500 rows an expert) the products, ~6 TFLOP a layer, so tiles
of 128 rows; at a decode step (512 tokens, ~48 rows an expert) reading
every touched expert's weights, 1.1 GB a layer in bf16, so one tile of
64 rows an expert, each expert's weights streamed once a tile
(``csrc/moe_experts.cu`` says how). (``torch._grouped_mm`` computes the
same products, but synchronises the host on the card's torch: a host wait
in every MoE layer of every step.)

Under ``train/profiling``: ``mpr.moe.route`` and ``mpr.moe.experts``
(spans, opened by the caller) and the counter ``moe.rows``, the
(token, expert) rows dispatched, counted from the shapes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodalpromptretrieval_tpu_torch.ops import _build


def route(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float, normalize: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., d) hidden states -> (expert ids (..., k) int64, weights (...,
    k) fp32). ``weight`` (E, d), ``bias`` (E,) the correction bias, which
    chooses the experts but does not weigh them."""
    scores = torch.sigmoid(torch.matmul(h.float(), weight.float().t()))
    _, idx = torch.topk(scores + bias.float(), top_k, dim=-1)
    w = scores.gather(-1, idx)
    if normalize:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * scale


def _expert(x: torch.Tensor, gate_up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """One SiLU-gated MLP: ``gate_up`` (2I, d) = [gate; up], ``down``
    (d, I)."""
    g, u = torch.matmul(x, gate_up.t()).chunk(2, dim=-1)
    return torch.matmul(torch.nn.functional.silu(g) * u, down.t())


def moe_experts_reference(h: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor, gate_up: torch.Tensor,
                          down: torch.Tensor) -> torch.Tensor:
    """The plain version: for each expert, its rows through it, weighted
    and added into the token's fp32 sum. (N, d) -> (N, d) fp32."""
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(gate_up.shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = _expert(h[tok], gate_up[e], down[e])
            out.index_add_(0, tok, y.float() * w[tok, slot, None])
    return out


def tile_rows(idx: torch.Tensor, n_experts: int, block_m: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled layout of the grouped kernels, built on the device from
    ``idx`` (N, k) alone: ``rows`` (tiles * block_m,) int32, the (token,
    slot) row (token * k + slot) at each place, the rows sorted by expert
    (stable) and each expert's run padded to whole tiles with N * k; and
    ``tile_expert`` (tiles,) int32, each tile's expert, -1 for the tiles
    past the last. ``tiles`` = ceil(N k / block_m) + E, a bound from the
    shapes (no host read of the counts)."""
    flat = idx.reshape(-1)
    M = flat.numel()
    dev = idx.device
    ids, order = torch.sort(flat, stable=True)
    experts = torch.arange(n_experts, device=dev, dtype=ids.dtype)
    ends = torch.searchsorted(ids, experts, right=True)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    padded = (counts + block_m - 1) // block_m * block_m
    p_ends = torch.cumsum(padded, dim=0)
    n_tiles = -(-M // block_m) + n_experts
    dest = (p_ends - padded)[ids] + torch.arange(M, device=dev) - (
        ends - counts)[ids]
    rows = torch.full((n_tiles * block_m,), M, dtype=torch.int32, device=dev)
    rows[dest] = order.to(torch.int32)
    starts = torch.arange(n_tiles, device=dev, dtype=p_ends.dtype) * block_m
    tile_expert = torch.searchsorted(p_ends, starts, right=True)
    tile_expert = torch.where(tile_expert < n_experts, tile_expert, -1)
    return rows, tile_expert.to(torch.int32)


# tile height of the layout: bf16 with many rows an expert (prefill), bf16
# with a few dozen (decode), fp32 (the CUDA-core kernels)
BLOCK_M_MANY, BLOCK_M_FEW, BLOCK_M_F32 = 128, 64, 64


def block_m(dtype: torch.dtype, rows_per_expert: float) -> int:
    """The tile height K10 runs for these inputs."""
    if dtype == torch.float32:
        return BLOCK_M_F32
    return BLOCK_M_MANY if rows_per_expert >= 256 else BLOCK_M_FEW


def moe_experts(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i E_{idx_i}(h)`` a token: ``h`` (N, d), ``idx`` / ``w``
    (N, k), ``gate_up`` (E, 2I, d), ``down`` (E, d, I); (N, d) fp32. CPU
    tensors take the reference, CUDA tensors the grouped kernels."""
    if h.device.type == "cpu":
        return moe_experts_reference(h, idx, w, gate_up, down)
    _build.require_cuda("moe_experts", h, idx, w, gate_up, down)
    if h.dtype != gate_up.dtype or h.dtype != down.dtype:
        raise TypeError(f"moe_experts: h {h.dtype}, experts "
                        f"{gate_up.dtype} / {down.dtype}")
    N, k = idx.shape
    E, d, I = gate_up.shape[0], h.shape[1], down.shape[2]
    if tuple(gate_up.shape) != (E, 2 * I, d) or tuple(down.shape) != (
            E, d, I) or tuple(w.shape) != (N, k) or h.shape[0] != N:
        raise ValueError(
            f"moe_experts: h {tuple(h.shape)}, idx {tuple(idx.shape)}, w "
            f"{tuple(w.shape)}, gate_up {tuple(gate_up.shape)}, down "
            f"{tuple(down.shape)}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moe_experts: dtype {h.dtype}")
    if d % 64 or I % 64:
        raise ValueError(f"moe_experts: the widths ({d}, {I}) must be "
                         "multiples of 64")
    bm = block_m(h.dtype, N * k / E)
    rows, tile_expert = tile_rows(idx, E, bm)
    if tile_expert.numel() > 65535:
        raise ValueError(f"moe_experts: {tile_expert.numel()} tiles of "
                         f"{bm} rows, more than a grid holds (65,535)")
    h, gate_up, down = h.contiguous(), gate_up.contiguous(), down.contiguous()
    act = torch.empty((rows.numel(), I), dtype=h.dtype, device=h.device)
    out = torch.empty((N * k, d), dtype=torch.float32, device=h.device)
    weight = w.reshape(-1).float().contiguous()
    lib = _build.library()
    _build.check(lib.mpr_moe_experts(
        h.data_ptr(), gate_up.data_ptr(), down.data_ptr(), rows.data_ptr(),
        tile_expert.data_ptr(), weight.data_ptr(), act.data_ptr(),
        out.data_ptr(), N, k, d, I, tile_expert.numel(), bm,
        0 if h.dtype == torch.float32 else 1, _build.stream_handle(h)),
        "mpr_moe_experts")
    _build.count_launch("moe_experts")
    return out.view(N, k, d).sum(dim=1)
