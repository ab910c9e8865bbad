"""int8 W8A8 serving weights (opt-in, off by default).

Counterpart of ``multimodalpromptretrieval_tpu/ops/quant.py``, with the same
scheme and the same arithmetic order:

  * weights: per-output-channel symmetric int8, ``s_w[j] = max_i |w[j, i]|
    / 127``, ``w_q = round(w / s_w)`` (round half to even, as ``jnp.round``);
  * activations: dynamic per-row symmetric int8, ``s_x[r] = max_i |x[r, i]|
    / 127``; an all-zero row gets scale 1e-12 / 127 and ``x_q = 0``;
  * ``y = ((acc.float() * s_x) * s_w)`` cast to the compute dtype, then
    ``+ bias``, over the exact int32 accumulator ``acc = x_q @ w_q.T``.

A quantized weight is a :class:`QWeight`: the int8 ``(out, in)`` payload of
an ``nn.Linear``-layout weight and its fp32 ``(out,)`` scale. It takes the
row slices the port takes of packed weights (T5's ``qkv[:W]``,
``qkv[W:2 * W]``): the scales are per output row, so a slice of the
quantized packed weight is the quantized slice, bit for bit (the JAX
package's ``kconcat`` / ``kslice`` exist for its layer-stacked kernels and
have no counterpart here). :func:`ops.layers.dense` dispatches on the
weight's type, so the full-precision path pays nothing.

The int8 product is the one library call of the path (the JAX package runs
it through ``lax.dot_general`` outside any Pallas kernel): ``torch._int_mm``
on the card, with the rows padded past its shape checks, and an exact
float64 product on the CPU.

:func:`quantize_params` makes the serving copy: T5 encoder and decoder
blocks (``qkv``, ``o``, ``wi``, ``wi_0``, ``wi_1``, ``wo``), and with
``clip=True`` the CLIP blocks of both towers (``qkv``, ``out``, ``fc``,
``proj``). The shared embedding / LM head stays at full precision: the
greedy argmax reads it. The masters are not touched, and every parameter
that is not quantized is shared with them, not copied.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch
from torch import nn

_EPS = 1e-12


class QWeight:
    """int8 ``(out, in)`` weight ``q8`` and fp32 ``(out,)`` scale
    ``q_scale``. Held as a plain module attribute, not a parameter, so
    ``Module.to(dtype)`` (the compute copy) leaves both dtypes alone."""

    __slots__ = ("q8", "q_scale")

    def __init__(self, q8: torch.Tensor, q_scale: torch.Tensor):
        self.q8 = q8
        self.q_scale = q_scale

    def __getitem__(self, rows: slice) -> "QWeight":
        return QWeight(self.q8[rows], self.q_scale[rows])


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, eps) / 127, divided as the JAX package divides. The
    divisor is a tensor: a Python-number divisor makes a CUDA tensor
    multiply by its reciprocal, one ulp off the quotient now and then."""
    return torch.clamp(amax, min=_EPS) / amax.new_full((), 127.0)


def quantize_kernel(w: torch.Tensor) -> QWeight:
    """(out, in) float weight -> :class:`QWeight`, one scale per row."""
    w32 = w.detach().float()
    scale = _scale(w32.abs().amax(dim=-1))
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return QWeight(q.to(torch.int8), scale)


def quantize_rows(x: torch.Tensor):
    """(..., K) -> (int8 x_q, fp32 (..., 1) scale), one scale per row."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ w.T`` of int8 (M, K) and (N, K) as int32: float64 holds
    every partial sum exactly (|sum| <= K * 127^2 < 2^53)."""
    return torch.matmul(a.double(), w.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (N, K).T -> int32 (M, N). A CPU tensor takes the
    exact plain version; a CUDA tensor the library int8 GEMM
    (``torch._int_mm``: int32 accumulator), whose shape checks ask for more
    than 16 rows and K, N multiples of 8: the rows are padded with zeros to
    a multiple of 8, at least 24, and the result sliced back."""
    if a.device.type == "cpu":
        return int8_matmul_reference(a, w)
    M, K = a.shape
    N = w.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"int8_matmul: K={K} and N={N} must be multiples "
                         "of 8 on the card")
    rows = max(24, -(-M // 8) * 8)
    if rows != M:
        a = torch.nn.functional.pad(a, (0, 0, 0, rows - M))
    return torch._int_mm(a.contiguous(), w.t())[:M]


def dense_q8(x: torch.Tensor, w: QWeight,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 dense: ``y = (x_q @ w_q.T) * s_x * s_w`` in the compute dtype
    (``x.dtype``), then ``+ bias``."""
    xq, sx = quantize_rows(x)
    K, N = x.shape[-1], w.q8.shape[0]
    acc = int8_matmul(xq.reshape(-1, K), w.q8)
    y = acc.float() * sx.reshape(-1, 1) * w.q_scale
    y = y.reshape(*x.shape[:-1], N).to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def _quantize_blocks(blocks: nn.Module) -> None:
    """In place: every ``Linear`` weight under ``blocks``, and T5's packed
    ``qkv`` parameter, becomes a :class:`QWeight`."""
    from multimodalpromptretrieval_tpu_torch.ops.layers import Linear

    for m in blocks.modules():
        names = (["weight"] if isinstance(m, Linear)
                 else ["qkv"] if isinstance(m._parameters.get("qkv"),
                                            nn.Parameter) else [])
        for name in names:
            q = quantize_kernel(getattr(m, name))
            delattr(m, name)
            setattr(m, name, q)


def quantize_params(params: nn.Module, *, t5: bool = True,
                    clip: bool = False) -> nn.Module:
    """A serving copy of ``params`` (an ``MPRGen``, fp32 masters) with the
    hot GEMM weights int8: T5's encoder and decoder blocks, and with
    ``clip=True`` both CLIP towers' blocks. Parameters left alone are the
    masters' own tensors."""
    shared = {id(p): p for p in params.parameters()}
    out = copy.deepcopy(params, memo=shared)
    if t5:
        _quantize_blocks(out.t5.encoder.block)
        _quantize_blocks(out.t5.decoder.block)
    if clip:
        _quantize_blocks(out.clip.visual.blocks)
        _quantize_blocks(out.clip.text.blocks)
    return out


def quantized_paths(params: nn.Module) -> List[str]:
    """Dotted names of every quantized weight in ``params``."""
    return [f"{mod}.{attr}" if mod else attr
            for mod, m in params.named_modules()
            for attr, v in vars(m).items() if isinstance(v, QWeight)]
