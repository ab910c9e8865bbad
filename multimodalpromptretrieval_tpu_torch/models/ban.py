"""Bilinear Attention Network fusion: the BAN variant's modules.

Counterpart of ``multimodalpromptretrieval_tpu/models/ban.py``, with the
same math: the reference's FCNet / BCNet (its vendored network/connect.py)
and the BiAttention / BiResNet of its BAN model.

  * every linear layer is ``weight_norm(..., dim=None)``: w = g * v /
    ||v||_F with a scalar g (``ops/layers.weight_norm_kernel``); ``v`` is
    stored (out, in), as ``nn.Linear`` stores it (the JAX package stores
    (in, out); ``bridge.py`` transposes);
  * FCNet applies [dropout, linear, ReLU] per layer, the ReLU after the
    LAST layer too unless ``act=""``;
  * BCNet with a glimpse count uses the broadcast ``h_mat`` path and is
    weight-normed over ``h_mat``;
  * BiAttention masks image rows that are all zero and question columns
    past ``q_valid`` with -inf, then softmaxes over the flattened
    (v * q) grid per glimpse;
  * BiResNet runs one bilinear pool per glimpse with a residual FCNet
    update of the question and sums over the question axis.

The modules hold the parameters; the functions below run them. Dropout is
drawn from ``gen`` (a ``torch.Generator`` on the device) and is off when
it is None. Nothing here reads a config: the caller passes the glimpse
count (``MPRGenConfig.glimpse``, 10 as in the reference).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from multimodalpromptretrieval_tpu_torch.ops.layers import (
    dense,
    dropout,
    uniform_param,
    weight_norm_kernel,
)


def _normal(shape, generator: Optional[torch.Generator]) -> nn.Parameter:
    if generator is None:
        return nn.Parameter(torch.empty(tuple(shape)))
    return nn.Parameter(torch.randn(tuple(shape), generator=generator))


def _frobenius(v: nn.Parameter) -> nn.Parameter:
    """g at wrap time: ||v||_F, so that the layer starts as v itself."""
    return nn.Parameter(torch.sqrt(torch.sum(torch.square(v.detach()))))


class WeightNormLinear(nn.Module):
    """A weight-normed linear layer: ``v`` (out, in), scalar ``g``, ``b``
    (out,), drawn as torch's ``nn.Linear`` default: U(+-1/sqrt(in))."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = in_dim ** -0.5
        self.v = uniform_param((out_dim, in_dim), bound, generator)
        self.g = (_frobenius(self.v) if generator is not None
                  else nn.Parameter(torch.empty(())))
        self.b = uniform_param((out_dim,), bound, generator)


class FCNet(nn.ModuleList):
    """One :class:`WeightNormLinear` per pair of consecutive ``dims``."""

    def __init__(self, dims: Sequence[int],
                 generator: Optional[torch.Generator]):
        super().__init__(WeightNormLinear(dims[i], dims[i + 1], generator)
                         for i in range(len(dims) - 1))


class BCNet(nn.Module):
    """Low-rank bilinear pooling: ``v_net`` / ``q_net`` to ``h_dim * k``,
    and with a glimpse count the weight-normed ``h_mat`` (``v`` (1, glimpse,
    1, h_dim * k), scalar ``g``) and ``h_bias`` (1, glimpse, 1, 1)."""

    def __init__(self, v_dim: int, q_dim: int, h_dim: int,
                 glimpse: Optional[int], k: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.v_net = FCNet([v_dim, h_dim * k], generator)
        self.q_net = FCNet([q_dim, h_dim * k], generator)
        if glimpse is not None:
            self.h_mat = nn.Module()
            self.h_mat.v = _normal((1, glimpse, 1, h_dim * k), generator)
            self.h_mat.g = (_frobenius(self.h_mat.v)
                            if generator is not None
                            else nn.Parameter(torch.empty(())))
            self.h_bias = _normal((1, glimpse, 1, 1), generator)


class BiAttention(nn.Module):
    """Bilinear attention maps: one :class:`BCNet` (k=3) with glimpses."""

    def __init__(self, x_dim: int, y_dim: int, z_dim: int, glimpse: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.logits = BCNet(x_dim, y_dim, z_dim, glimpse, 3, generator)


class BiResNet(nn.Module):
    """Per glimpse a :class:`BCNet` (k=1) and a residual question
    projection ``q_prj`` (an FCNet without activation)."""

    def __init__(self, v_dim: int, q_dim: int, glimpse: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.b_net = nn.ModuleList(
            BCNet(v_dim, q_dim, q_dim, None, 1, generator)
            for _ in range(glimpse))
        self.q_prj = nn.ModuleList(FCNet([q_dim, q_dim], generator)
                                   for _ in range(glimpse))


def fcnet_apply(layers: FCNet, x: torch.Tensor, *, act: str = "relu",
                rate: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    for layer in layers:
        x = dropout(x, rate, gen)
        x = dense(x, weight_norm_kernel(layer.v, layer.g), layer.b)
        if act == "relu":
            x = torch.relu(x)
    return x


def bcnet_logits(p: BCNet, v: torch.Tensor, q: torch.Tensor, *,
                 rates=(0.2, 0.5),
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(b, glimpse, nv, nq) bilinear logits of v (b, nv, v_dim) and q (b,
    nq, q_dim)."""
    v_ = fcnet_apply(p.v_net, v, rate=rates[0], gen=gen)
    q_ = fcnet_apply(p.q_net, q, rate=rates[0], gen=gen)
    v_ = dropout(v_, rates[1], gen)[:, None]            # (b, 1, nv, h k)
    h_ = v_ * weight_norm_kernel(p.h_mat.v, p.h_mat.g)  # (b, g, nv, h k)
    logits = torch.matmul(h_, q_[:, None].transpose(-1, -2))
    return logits + p.h_bias


def bcnet_forward_with_weights(p: BCNet, v: torch.Tensor, q: torch.Tensor,
                               w: torch.Tensor, *, rate: float = 0.2,
                               gen: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """v'ᵀ w q' per feature: v (b, nv, v_dim), q (b, nq, q_dim), w (b, nv,
    nq) -> (b, h_dim), the JAX ``einsum("bvd,bvq,bqd->bd")`` (k=1, so no
    pooling). ``w`` meets ``v'`` first, (b, nq, h), and the product with
    ``q'`` is summed over nq: a left-to-right einsum would materialise (b,
    nv, h, nq)."""
    v_ = fcnet_apply(p.v_net, v, rate=rate, gen=gen)   # (b, nv, h)
    q_ = fcnet_apply(p.q_net, q, rate=rate, gen=gen)   # (b, nq, h)
    wv = torch.matmul(w.transpose(1, 2), v_)            # (b, nq, h)
    return torch.sum(wv * q_, dim=1)


def biattention_apply(p: BiAttention, v: torch.Tensor, q: torch.Tensor, *,
                      v_mask: bool = True,
                      q_valid: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None):
    """(attention (b, glimpse, nv, nq), logits). ``q_valid`` (b, nq) bool
    marks the question columns the reference's longest-row padding has;
    the others get -inf, so a wider bucket changes nothing."""
    logits = bcnet_logits(p.logits, v, q, gen=gen)
    if v_mask:
        empty = (torch.sum(torch.abs(v), dim=2) == 0)[:, None, :, None]
        logits = logits.masked_fill(empty, float("-inf"))
    if q_valid is not None:
        logits = logits.masked_fill(~q_valid[:, None, None, :],
                                    float("-inf"))
    b, g, nv, nq = logits.shape
    att = torch.softmax(logits.reshape(b, g, nv * nq), dim=2)
    return att.reshape(b, g, nv, nq), logits


def biresnet_apply(p: BiResNet, v_emb: torch.Tensor, q_emb: torch.Tensor,
                   att: torch.Tensor, *,
                   q_valid: Optional[torch.Tensor] = None,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glimpse-by-glimpse fusion -> (b, q_dim): the question columns past
    ``q_valid`` are zeroed before the final sum over them."""
    for g, (b_net, q_prj) in enumerate(zip(p.b_net, p.q_prj)):
        b_emb = bcnet_forward_with_weights(b_net, v_emb, q_emb, att[:, g],
                                           gen=gen)
        q_emb = fcnet_apply(q_prj, b_emb[:, None], act="", rate=0.2,
                            gen=gen) + q_emb
    if q_valid is not None:
        q_emb = torch.where(q_valid[:, :, None], q_emb, 0.0)
    return q_emb.sum(dim=1)
