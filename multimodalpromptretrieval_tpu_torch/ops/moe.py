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
* :func:`moe_experts_held`: one expert-parallel rank's share (the
  Kimi-Linear LM: 64 of 256 experts held). The router still scores every
  expert; the layout gives the rows routed to held experts their tiles as
  above and the others no place at all (the same bound on the tiles, from
  the shapes), and their fp32 rows stay zero. Holding every expert, it is
  :func:`moe_experts` to the bit.

What bounds it on the H100: at prefill (58,368 tokens x 6 rows over 64
experts, ~5,500 rows an expert) the products, ~6 TFLOP a layer, so tiles
of 128 rows on ``wgmma`` fed by TMA; at a decode step (512 tokens, ~48
rows an expert) reading every touched expert's weights, 1.1 GB a layer in
bf16, so one tile of 64 rows an expert on ``mma.sync``, each expert's
weights streamed once a tile (``csrc/moe_experts.cu`` says how).
(``torch._grouped_mm`` computes the same products, but synchronises the
host on the card's torch: a host wait in every MoE layer of every step.)

Under ``train/profiling``, all opened and counted by the caller:
``mpr.moe.route`` and ``mpr.moe.experts`` (spans) and the counters
``moe.rows``, the (token, expert) rows dispatched, and ``moe.rows_wgmma``,
those of them sent through the 128-row ``wgmma`` kernels (CUDA tensors
with ``block_m`` 128); both counted from the shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
                          down: torch.Tensor, first: int = 0) -> torch.Tensor:
    """The plain version: for each expert held (ids ``first`` .. ``first +
    E - 1`` are ``gate_up[0 .. E - 1]``), its rows through it, weighted and
    added into the token's fp32 sum; rows routed elsewhere add nothing.
    (N, d) -> (N, d) fp32."""
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(gate_up.shape[0]):
        tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel():
            y = _expert(h[tok], gate_up[e], down[e])
            out.index_add_(0, tok, y.float() * w[tok, slot, None])
    return out


def tile_rows(idx: torch.Tensor, n_experts: int, block_m: int,
              first: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled layout of the grouped kernels, built on the device from
    ``idx`` (N, k) alone: ``rows`` (tiles * block_m,) int32, the (token,
    slot) row (token * k + slot) at each place, the rows sorted by expert
    (stable) and each expert's run padded to whole tiles with N * k; and
    ``tile_expert`` (tiles,) int32, each tile's expert, -1 for the tiles
    past the last. ``tiles`` = ceil(N k / block_m) + E, a bound from the
    shapes (no host read of the counts). With ``first``, the E experts held
    are the ids ``first`` .. ``first + E - 1``: the rows routed to any other
    get no place and no tile."""
    flat = idx.reshape(-1)
    M = flat.numel()
    dev = idx.device
    if first is not None:
        flat = flat - first
        flat = torch.where((flat >= 0) & (flat < n_experts), flat, n_experts)
    ids, order = torch.sort(flat, stable=True)
    experts = torch.arange(n_experts, device=dev, dtype=ids.dtype)
    ends = torch.searchsorted(ids, experts, right=True)
    counts = torch.diff(ends, prepend=ends.new_zeros(1))
    padded = (counts + block_m - 1) // block_m * block_m
    p_ends = torch.cumsum(padded, dim=0)
    n_tiles = -(-M // block_m) + n_experts
    at = ids if first is None else ids.clamp(max=n_experts - 1)
    dest = (p_ends - padded)[at] + torch.arange(M, device=dev) - (
        ends - counts)[at]
    if first is None:
        rows = torch.full((n_tiles * block_m,), M, dtype=torch.int32,
                          device=dev)
        rows[dest] = order.to(torch.int32)
    else:  # the rows of absent experts go to one place past the end
        dest = torch.where(ids < n_experts, dest, n_tiles * block_m)
        rows = torch.full((n_tiles * block_m + 1,), M, dtype=torch.int32,
                          device=dev)
        rows[dest] = order.to(torch.int32)
        rows = rows[:-1]
    starts = torch.arange(n_tiles, device=dev, dtype=p_ends.dtype) * block_m
    tile_expert = torch.searchsorted(p_ends, starts, right=True)
    tile_expert = torch.where(tile_expert < n_experts, tile_expert, -1)
    return rows, tile_expert.to(torch.int32)


# tile height of the layout: bf16 with many rows an expert (prefill, the
# wgmma kernels), bf16 with a few dozen (decode), fp32 (the CUDA-core
# kernels)
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
    return _grouped(h, idx, w, gate_up, down, None, gate_up.shape[0])


def moe_experts_held(h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     gate_up: torch.Tensor, down: torch.Tensor,
                     first: int, routed: int) -> torch.Tensor:
    """One expert-parallel rank's share of :func:`moe_experts`: ``idx``
    routes over all ``routed`` experts, this rank holds the E of
    ``gate_up`` / ``down``, ids ``first`` .. ``first + E - 1``. The rows
    routed to held experts go through them as in :func:`moe_experts`; the
    others get no tile and add nothing (the other ranks' part, not computed
    here). The tile height follows the rows an expert gets on average,
    N k / ``routed``."""
    return _grouped(h, idx, w, gate_up, down, first, routed)


def _grouped(h, idx, w, gate_up, down, first: Optional[int],
             routed: int) -> torch.Tensor:
    if h.device.type == "cpu":
        return moe_experts_reference(h, idx, w, gate_up, down, first or 0)
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
    bm = block_m(h.dtype, N * k / routed)
    rows, tile_expert = tile_rows(idx, E, bm, first)
    if tile_expert.numel() > 65535:
        raise ValueError(f"moe_experts: {tile_expert.numel()} tiles of "
                         f"{bm} rows, more than a grid holds (65,535)")
    # the C side reads E back from this count for the wgmma kernels' maps
    assert tile_expert.numel() == -(-N * k // bm) + E, tile_expert.numel()
    h, gate_up, down = h.contiguous(), gate_up.contiguous(), down.contiguous()
    act = torch.empty((rows.numel(), I), dtype=h.dtype, device=h.device)
    # a held share leaves the rows of absent experts unwritten: zeros
    out = (torch.empty if first is None else torch.zeros)(
        (N * k, d), dtype=torch.float32, device=h.device)
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
