"""CLIP image preprocessing on the device.

Counterpart of ``multimodalpromptretrieval_tpu/ops/image.py``: scale the
shorter side to ``size`` (bicubic with antialiasing, the long side
truncated as torchvision does), center-crop ``size`` x ``size``, clip to
[0, 1] and normalize with CLIP's mean / std.

The JAX function resizes with ``jax.image.resize(..., "bicubic",
antialias=True)``, which is not what ``torch.nn.functional.interpolate``
computes. So each axis gets the weight matrix that
``jax.image.scale_and_translate`` builds: a Keys cubic (a = -0.5) at the
half-pixel sample positions, widened by the scale when downsampling, the
weights of each output pixel renormalised to sum to one (the edges), an
axis of unchanged length left alone. The matrices are made on the host in
JAX's float32 arithmetic and applied with two fp32 products on the
device. This runs once
per unique image when a cache is built, not on the serving hot path.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.models.clip import (
    IMAGE_MEAN,
    IMAGE_STD,
)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + two, out)
    return np.where(x >= two, np.float32(0.0), out)


@functools.lru_cache(maxsize=32)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of an antialiased bicubic resize
    along one axis: ``jax.image``'s ``compute_weight_mat`` with translation
    0, in its float32 arithmetic (the sample positions' rounding moves the
    weights by about 1e-5 at 224 px)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
              - f32(0.5))
    x = np.abs(sample[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resized_shape(h: int, w: int, size: int):
    """The shorter side to ``size``, the long side truncated (``int()``,
    torchvision's ``_compute_resized_output_size``)."""
    if h <= w:
        return size, max(size, int(size * w / h))
    return max(size, int(size * h / w)), size


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(N, H, W, 3) uint8 / float -> (N, 3, size, size) float32 normalized,
    on the images' device."""
    _, h, w, _ = images.shape
    x = images.float() / 255.0
    nh, nw = resized_shape(h, w, size)
    dev = images.device
    if nh != h:
        wh = torch.from_numpy(resize_weights(h, nh)).to(dev)
        x = torch.einsum("nhwc,hy->nywc", x, wh)
    if nw != w:
        ww = torch.from_numpy(resize_weights(w, nw)).to(dev)
        x = torch.einsum("nhwc,wx->nhxc", x, ww)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = torch.clamp(x[:, top:top + size, left:left + size], 0.0, 1.0)
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=dev)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def preprocess_arrays(arrays: Sequence[np.ndarray], size: int = 224,
                      batch: int = 64,
                      device: Optional[torch.device] = None
                      ) -> List[np.ndarray]:
    """(H, W, 3) uint8 arrays, grouped by resolution and preprocessed in
    batches on ``device`` (default the CPU). Returns (3, size, size)
    float32 arrays in input order."""
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a.shape, []).append(i)
    out: List[Optional[np.ndarray]] = [None] * len(arrays)
    for idxs in groups.values():
        for s in range(0, len(idxs), batch):
            chunk = idxs[s:s + batch]
            stacked = torch.from_numpy(np.stack([arrays[i] for i in chunk]))
            res = clip_preprocess(stacked.to(device or "cpu"),
                                  size=size).cpu().numpy()
            for j, i in enumerate(chunk):
                out[i] = res[j]
    return out


def preprocess_pil_images(pil_images, size: int = 224, batch: int = 64,
                          device: Optional[torch.device] = None
                          ) -> List[np.ndarray]:
    """PIL images -> (3, size, size) float32 arrays in input order, through
    :func:`preprocess_arrays`."""
    arrays = []
    for im in pil_images:
        if im.mode != "RGB":
            im = im.convert("RGB")
        arrays.append(np.asarray(im, np.uint8))
    return preprocess_arrays(arrays, size=size, batch=batch, device=device)
