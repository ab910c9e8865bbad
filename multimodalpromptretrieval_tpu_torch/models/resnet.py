"""CLIP's ModifiedResNet visual tower (the reference's "Use RNx4" branch).

Counterpart of ``multimodalpromptretrieval_tpu/models/resnet.py``. The
reference takes layer4's grid features, (B, grid^2, 32 * width) with no CLS
token, and projects them to the T5 space by a trainable Linear (the model's
``rn_proj``, ``models/mprgen.py``); the attention pool is skipped on that
path and kept here for ``encode_image``:

  * a 3-conv stem (stride 2, then 1, 1; each conv + BatchNorm + ReLU), then
    a 2x2 average pool;
  * Bottleneck blocks with expansion 4; a stride-2 block average-pools
    before its last 1x1 conv, and its shortcut is average pool -> 1x1 conv
    -> BatchNorm (OpenAI's ``downsample.0`` / ``downsample.1``);
  * the AttentionPool2d head: the mean token prepended, the positional
    table added, one multi-head attention with the mean token as the query.

BatchNorm runs in inference mode on the checkpoint's running statistics
(eps 1e-5): the tower is frozen, and its four tensors per norm are frozen
parameters, as they are leaves of the JAX tree. Convolutions are
``F.conv2d`` in NCHW with torch's symmetric padding ``(k - 1) // 2``. Every
op runs in the dtype of its inputs: under a bf16 compute copy the norms'
scale and shift are computed in bf16, as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalpromptretrieval_tpu_torch.ops.layers import Linear, param


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: tuple = (3, 4, 6, 3)       # RN50; RN50x4 = (4, 6, 10, 6)
    width: int = 64                    # stem width (RN50x4 = 80)
    embed_dim: int = 1024              # attnpool output (RN50x4 = 640)
    heads: int = 32                    # attnpool heads (width * 32 // 64)
    image_resolution: int = 224        # RN50x4 = 288

    @property
    def final_channels(self) -> int:
        return self.width * 32         # layer4's channels (x4 expansion)

    @property
    def grid(self) -> int:
        return self.image_resolution // 32

    @staticmethod
    def rn50() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def rn50x4() -> "ResNetConfig":
        return ResNetConfig(layers=(4, 6, 10, 6), width=80, embed_dim=640,
                            heads=40, image_resolution=288)

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(layers=(1, 1, 1, 1), width=8, embed_dim=32,
                            heads=4, image_resolution=64)


def blocks(cfg: ResNetConfig) -> Iterator[Tuple[int, int, int, int, int]]:
    """(layer, block, in channels, mid channels, stride) of every
    Bottleneck. The stride is structural (2 for the first block of layers 2
    to 4), never stored; a block has a shortcut conv when it strides or
    changes the width."""
    cin = cfg.width
    for li, n in enumerate(cfg.layers):
        cmid = cfg.width * 2 ** li
        for bi in range(n):
            yield li, bi, cin, cmid, 1 if li == 0 or bi > 0 else 2
            cin = cmid * 4


def has_downsample(cin: int, cmid: int, stride: int) -> bool:
    return stride > 1 or cin != cmid * 4


def _conv(cin: int, cout: int, k: int,
          generator: Optional[torch.Generator]) -> nn.Parameter:
    return param((cout, cin, k, k), generator, std=(cin * k * k) ** -0.5)


class BatchNorm(nn.Module):
    """Scale, shift, running mean and running variance (ones, zeros,
    zeros, ones at init)."""

    def __init__(self, c: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = param((c,), generator, fill=1.0)
        self.bias = param((c,), generator)
        self.mean = param((c,), generator)
        self.var = param((c,), generator, fill=1.0)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = _conv(cin, cout, 1, generator)
        self.bn = BatchNorm(cout, generator)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, stride: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv1 = _conv(cin, cmid, 1, generator)
        self.bn1 = BatchNorm(cmid, generator)
        self.conv2 = _conv(cmid, cmid, 3, generator)
        self.bn2 = BatchNorm(cmid, generator)
        self.conv3 = _conv(cmid, cmid * 4, 1, generator)
        self.bn3 = BatchNorm(cmid * 4, generator)
        self.downsample = (Downsample(cin, cmid * 4, generator)
                           if has_downsample(cin, cmid, stride) else None)


class AttentionPool(nn.Module):
    """The positional table (grid^2 + 1, C), q / k / v (C -> C) and the
    output projection (C -> embed_dim)."""

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator]):
        super().__init__()
        c, s = cfg.final_channels, cfg.final_channels ** -0.5
        self.pos = param((cfg.grid ** 2 + 1, c), generator, std=s)
        for name in ("q", "k", "v"):
            setattr(self, name, Linear(c, c, bias=True, std=s,
                                       generator=generator))
        self.out = Linear(c, cfg.embed_dim, bias=True, std=s,
                          generator=generator)


class ResNet(nn.Module):
    """The tower's parameters. ``generator`` draws the seeded random init
    (normal convs scaled by fan_in^-1/2, identity norms); ``None`` leaves
    them to be loaded."""

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = cfg.width
        self.conv1 = _conv(3, w // 2, 3, generator)
        self.bn1 = BatchNorm(w // 2, generator)
        self.conv2 = _conv(w // 2, w // 2, 3, generator)
        self.bn2 = BatchNorm(w // 2, generator)
        self.conv3 = _conv(w // 2, w, 3, generator)
        self.bn3 = BatchNorm(w, generator)
        layers = [nn.ModuleList() for _ in cfg.layers]
        for li, _, cin, cmid, stride in blocks(cfg):
            layers[li].append(Bottleneck(cin, cmid, stride, generator))
        for li, layer in enumerate(layers):
            setattr(self, f"layer{li + 1}", layer)
        self.attnpool = AttentionPool(cfg, generator)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """torch Conv2d semantics: symmetric padding (k - 1) // 2."""
    return F.conv2d(x, w, stride=stride, padding=(w.shape[2] - 1) // 2)


def batch_norm(x: torch.Tensor, p: BatchNorm,
               eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over NCHW, in the parameters' dtype."""
    inv = torch.rsqrt(p.var + eps)
    scale = (p.weight * inv)[None, :, None, None]
    shift = (p.bias - p.mean * p.weight * inv)[None, :, None, None]
    return x * scale + shift


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x, k, k)


def _bottleneck(p: Bottleneck, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = torch.relu(batch_norm(conv2d(x, p.conv1), p.bn1))
    out = torch.relu(batch_norm(conv2d(out, p.conv2), p.bn2))
    if stride > 1:
        out = avg_pool(out, stride)
    out = batch_norm(conv2d(out, p.conv3), p.bn3)
    idn = x
    if p.downsample is not None:
        if stride > 1:
            idn = avg_pool(idn, stride)
        idn = batch_norm(conv2d(idn, p.downsample.conv), p.downsample.bn)
    return torch.relu(out + idn)


def resnet_grid_features(params: ResNet, cfg: ResNetConfig,
                         images: torch.Tensor) -> torch.Tensor:
    """(B, 3, R, R) -> layer4's grid features (B, (R/32)^2, 32 * width),
    row-major over the grid: the reference's ``get_resnet_features`` before
    its projection."""
    x = torch.relu(batch_norm(conv2d(images, params.conv1, stride=2),
                              params.bn1))
    x = torch.relu(batch_norm(conv2d(x, params.conv2), params.bn2))
    x = torch.relu(batch_norm(conv2d(x, params.conv3), params.bn3))
    x = avg_pool(x, 2)
    for li, bi, _, _, stride in blocks(cfg):
        x = _bottleneck(getattr(params, f"layer{li + 1}")[bi], x, stride)
    B, C, H, W = x.shape
    return x.reshape(B, C, H * W).transpose(1, 2)


def resnet_encode_image(params: ResNet, cfg: ResNetConfig,
                        images: torch.Tensor) -> torch.Tensor:
    """The AttentionPool2d head -> (B, embed_dim), OpenAI ``encode_image``.
    The positional table fixes the grid: RN50x4's (288 px) does not fit a
    224 px image, which raises, as in the JAX package."""
    feats = resnet_grid_features(params, cfg, images)  # (B, HW, C)
    ap = params.attnpool
    B, _, C = feats.shape
    H = cfg.heads
    Dh = C // H
    tokens = torch.cat([feats.mean(dim=1, keepdim=True), feats],
                       dim=1) + ap.pos[None]

    def proj(t, p):
        return (torch.matmul(t, p.weight.t()) + p.bias).reshape(
            B, -1, H, Dh).transpose(1, 2)

    q, k, v = proj(tokens[:, :1], ap.q), proj(tokens, ap.k), proj(tokens,
                                                                 ap.v)
    scores = torch.matmul(q, k.transpose(-1, -2)) * Dh ** -0.5
    o = torch.matmul(torch.softmax(scores, dim=-1), v)
    o = o.transpose(1, 2).reshape(B, C)
    return torch.matmul(o, ap.out.weight.t()) + ap.out.bias


# ---------------------------------------------------------------------------
# OpenAI checkpoint conversion (host numpy, the JAX tree's layout)
# ---------------------------------------------------------------------------


def resnet_config_from_openai_sd(sd: Mapping[str, np.ndarray]
                                 ) -> ResNetConfig:
    """The tower's config from an OpenAI-layout state dict (as
    ``clip.load`` infers it)."""
    width = sd["visual.conv3.weight"].shape[0]
    layers = tuple(len({k.split(".")[2] for k in sd
                        if k.startswith(f"visual.layer{li}.")})
                   for li in range(1, 5))
    spacial = int(round((sd["visual.attnpool.positional_embedding"]
                         .shape[0] - 1) ** 0.5))
    return ResNetConfig(layers=layers, width=width,
                        embed_dim=sd["visual.attnpool.c_proj.weight"].shape[0],
                        heads=width * 32 // 64,
                        image_resolution=spacial * 32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _bn_from(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"w": _f32(sd[f"{prefix}.weight"]), "b": _f32(sd[f"{prefix}.bias"]),
            "mean": _f32(sd[f"{prefix}.running_mean"]),
            "var": _f32(sd[f"{prefix}.running_var"])}


def resnet_from_openai(sd: Mapping[str, np.ndarray],
                       cfg: ResNetConfig) -> Dict[str, Any]:
    """An OpenAI-layout ModifiedResNet state dict (``visual.*``) -> the JAX
    package's ``clip_rn`` tree, as numpy: ``bridge.py`` makes the module of
    it. OpenAI names the shortcut Sequential ``[("-1", AvgPool), ("0",
    Conv), ("1", BN)]``, so a block's shortcut conv is ``downsample.0`` and
    its norm ``downsample.1``; a block has one when the file does."""
    tree: Dict[str, Any] = {}
    for i in (1, 2, 3):
        tree[f"conv{i}"] = _f32(sd[f"visual.conv{i}.weight"])
        tree[f"bn{i}"] = _bn_from(sd, f"visual.bn{i}")
    for li, n in enumerate(cfg.layers):
        layer = []
        for bi in range(n):
            pre = f"visual.layer{li + 1}.{bi}"
            b = {}
            for i in (1, 2, 3):
                b[f"conv{i}"] = _f32(sd[f"{pre}.conv{i}.weight"])
                b[f"bn{i}"] = _bn_from(sd, f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in sd:
                b["downsample"] = {
                    "conv": _f32(sd[f"{pre}.downsample.0.weight"]),
                    "bn": _bn_from(sd, f"{pre}.downsample.1")}
            layer.append(b)
        tree[f"layer{li + 1}"] = layer
    ap = "visual.attnpool"
    tree["attnpool"] = {"pos": _f32(sd[f"{ap}.positional_embedding"])}
    for name in ("q", "k", "v"):
        tree["attnpool"][name] = {"w": _f32(sd[f"{ap}.{name}_proj.weight"]),
                                  "b": _f32(sd[f"{ap}.{name}_proj.bias"])}
    tree["attnpool"]["out"] = {
        "w": np.ascontiguousarray(_f32(sd[f"{ap}.c_proj.weight"]).T),
        "b": _f32(sd[f"{ap}.c_proj.bias"])}
    return tree
