"""Normalization and pointwise layers shared by the T5 and CLIP towers.

Counterpart of ``multimodalpromptretrieval_tpu/ops/layers.py``, with the
same numerics:

  * ``rms_norm``   == HF ``T5LayerNorm`` (no mean, no bias, fp32 variance);
  * ``layer_norm`` == ``torch.nn.LayerNorm`` math (biased variance, affine);
  * ``quick_gelu`` == OpenAI CLIP's ``QuickGELU``;
  * ``gelu_new``   == HF's tanh-approximated GELU;
  * ``weight_norm_kernel`` == ``torch.nn.utils.weight_norm(dim=None)``.

Both norms reduce in fp32 and cast back to the input dtype BEFORE the
affine step, as the reference's torch modules do; under bf16 that rounding
point is visible.

``dense`` takes a torch-layout ``(out, in)`` weight (``nn.Linear``); the
JAX package stores ``(in, out)`` and ``bridge.py`` transposes once. An int8
serving weight (``ops/quant.QWeight``) takes the W8A8 product instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.ops.quant import QWeight, dense_q8


def param(shape: Sequence[int], generator: Optional[torch.Generator], *,
          std: float = 0.0, fill: float = 0.0) -> nn.Parameter:
    """A parameter drawn N(0, std^2) from ``generator`` (or ``fill`` when
    ``std`` is 0). ``generator=None`` leaves it uninitialised, for modules
    whose every value is loaded afterwards (``bridge.py``)."""
    if generator is None:
        return nn.Parameter(torch.empty(tuple(shape)))
    if std:
        return nn.Parameter(torch.randn(tuple(shape), generator=generator)
                            * std)
    return nn.Parameter(torch.full(tuple(shape), fill))


def uniform_param(shape: Sequence[int], bound: float,
                  generator: Optional[torch.Generator]) -> nn.Parameter:
    """A parameter drawn U(-bound, bound) from ``generator`` (torch's
    ``nn.Linear`` default init with ``bound = in ** -0.5``); ``None``
    leaves it uninitialised, as :func:`param` does."""
    if generator is None:
        return nn.Parameter(torch.empty(tuple(shape)))
    return nn.Parameter((torch.rand(tuple(shape), generator=generator) * 2
                         - 1) * bound)


class Linear(nn.Module):
    """``dense`` with an ``(out, in)`` weight and an optional zero-init
    bias."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool, std: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = param((out_dim, in_dim), generator, std=std)
        self.bias = param((out_dim,), generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm affine parameters (ones / zeros at init)."""

    def __init__(self, width: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = param((width,), generator, fill=1.0)
        self.bias = param((width,), generator)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    variance = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.reciprocal(torch.sqrt(variance + eps))
    return weight * x32.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (y.to(x.dtype) * weight + bias).to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias), weight (out, in). The bias is added after
    the product is rounded to the compute dtype, as the JAX ``dense`` does
    (a fused GEMM epilogue would round once instead of twice). A
    :class:`~ops.quant.QWeight` runs ``dense_q8``, as the JAX ``dense``
    dispatches on a quantized kernel."""
    if isinstance(weight, QWeight):
        return dense_q8(x, weight, bias)
    y = torch.matmul(x, weight.t())
    if bias is not None:
        y = y + bias
    return y


class BatchShard:
    """Where dropout masks come from: ``generator``, with each mask drawn at
    ``count`` times the local leading dimension and block ``index`` of its
    rows kept. A data-parallel rank holds the run's seeded generator with
    its ``index`` among ``count`` ranks, so the ranks together apply the
    masks one process would over the whole batch (every dropout site has
    the batch, or its ``B * L`` rows, leading); ``count`` 1 is the plain
    draw. ``get_state`` / ``set_state`` are the generator's (the remat
    replay)."""

    def __init__(self, generator: torch.Generator, index: int = 0,
                 count: int = 1):
        self.generator, self.index, self.count = generator, index, count

    def keep(self, shape: Sequence[int], rate: float,
             device) -> torch.Tensor:
        """The boolean keep-mask of ``shape``: uniform draws >= ``rate``."""
        n = shape[0]
        u = torch.rand((n * self.count,) + tuple(shape[1:]),
                       generator=self.generator, device=device)
        return u[self.index * n:(self.index + 1) * n] >= rate

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


class ColumnBlock:
    """Masks of ``source`` drawn at ``count`` times the last dimension, of
    which block ``index`` is kept: a tensor-parallel rank's FF columns of
    the mask one process draws over the whole ``d_ff``."""

    def __init__(self, source, index: int, count: int):
        self.source, self.index, self.count = source, index, count

    def keep(self, shape: Sequence[int], rate: float,
             device) -> torch.Tensor:
        c = shape[-1]
        full = self.source.keep(tuple(shape[:-1]) + (c * self.count,), rate,
                                device)
        return full[..., self.index * c:(self.index + 1) * c]


def column_block(source, index: int, count: int):
    """``source`` (None, a ``torch.Generator`` or a mask source) as the
    source of column block ``index`` of ``count``; itself when ``count``
    is 1 or there is no source."""
    if source is None or count == 1:
        return source
    if isinstance(source, torch.Generator):
        source = BatchShard(source)
    return ColumnBlock(source, index, count)


class MaskTape:
    """Keep-masks drawn ahead, handed out in turn (rows ``rows`` of each):
    a pipeline stage's masks for one microbatch, drawn at the step's start
    in one process's order. ``get_state`` / ``set_state`` are the position
    (the remat replay)."""

    def __init__(self, masks: Sequence[torch.Tensor], rows=slice(None)):
        self.masks, self.rows, self.pos = masks, rows, 0

    def keep(self, shape: Sequence[int], rate: float,
             device) -> torch.Tensor:
        mask = self.masks[self.pos][self.rows]
        self.pos += 1
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"dropout mask {tuple(mask.shape)} drawn for "
                             f"{tuple(shape)}: the sites are out of order")
        return mask

    def get_state(self) -> int:
        return self.pos

    def set_state(self, state: int) -> None:
        self.pos = state


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout: each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``. ``rate <= 0`` or
    ``generator is None`` (evaluation) is the identity. ``generator``, a
    ``torch.Generator`` (taken as ``BatchShard(generator)``) or a mask
    source (:class:`BatchShard`, :class:`ColumnBlock`, :class:`MaskTape`),
    must live on ``x``'s device. Only the rate and the
    positions where dropout is applied are a parity surface with the JAX
    package, never the bits."""
    if generator is None or rate <= 0.0:
        return x
    if isinstance(generator, torch.Generator):
        generator = BatchShard(generator)
    keep = generator.keep(x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), written as the JAX version writes it."""
    return x * torch.reciprocal(1.0 + torch.exp(-1.702 * x))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(
        0.7978845608028654 * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``torch.nn.utils.weight_norm`` with ``dim=None``: w = g * v / ||v||_F
    with a scalar ``g``, the norm over the whole tensor. The norm and the
    scaling run in fp32 and the result is cast back to ``v``'s dtype (the
    BAN fusion's layers, ``models/ban.py``)."""
    v32 = v.float()
    norm = torch.sqrt(torch.sum(torch.square(v32)))
    return (g * v32 / norm).to(v.dtype)
