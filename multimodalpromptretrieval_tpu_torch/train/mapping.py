"""The cross-modal mapping trainer: CLIP image features -> a text space.

Counterpart of ``multimodalpromptretrieval_tpu/train/mapping.py`` (the
reference's ``create_mapping.py``, whose own trainer does not run). The
module (Linear -> ReLU -> Linear plus a learned ``logit_scale``) is
``models/mprgen.Mapping``; with ``use_mapping`` it maps the ViT tokens
before the T5 prefix. Here: CLIP-style symmetric InfoNCE between mapped
image features and text features, trained with the port's AdamW over a
seeded permutation per epoch (drop-last batches), a top-k retrieval
accuracy, and a 2-D PCA of both modalities (numpy SVD; matplotlib only
when a plot is written).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.models.mprgen import (
    Mapping,
    mapping_apply,
)
from multimodalpromptretrieval_tpu_torch.serving import resolve_device
from multimodalpromptretrieval_tpu_torch.train.optim import (
    adamw_init,
    adamw_update,
)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def contrastive_loss(params: Mapping, image_feats: torch.Tensor,
                     text_feats: torch.Tensor) -> torch.Tensor:
    """Symmetric cross-entropy over the cosine logits of mapped image
    features against text features, scaled by exp(``logit_scale``); row i
    of each is a pair."""
    mapped = _unit(mapping_apply(params, image_feats))
    logits = (torch.exp(params.logit_scale) * mapped) @ _unit(text_feats).t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = -torch.mean(torch.log_softmax(logits, dim=1)[labels, labels])
    lt = -torch.mean(torch.log_softmax(logits.t(), dim=1)[labels, labels])
    return 0.5 * (li + lt)


def train_mapping(image_feats: np.ndarray, text_feats: np.ndarray, *,
                  epochs: int = 30, batch_size: int = 64, lr: float = 1e-4,
                  seed: int = 0, quiet: bool = True,
                  device: Optional[torch.device] = None,
                  init: Optional[Mapping] = None,
                  losses: Optional[List[float]] = None) -> Mapping:
    """Fit the mapping on paired (N, D) features: each epoch a permutation
    from ``numpy.random.default_rng(seed)``, batches of ``batch_size`` (the
    last short one dropped), one AdamW step each. ``init``: the starting
    module (default: drawn from ``seed``); ``losses`` collects each step's
    loss. Runs on ``device`` (the features go there once); None is the
    card (:func:`~multimodalpromptretrieval_tpu_torch.serving.
    resolve_device`)."""
    device = resolve_device(device)
    params = (init if init is not None
              else Mapping(image_feats.shape[1],
                           torch.Generator().manual_seed(seed))).to(device)
    img = torch.as_tensor(np.asarray(image_feats, np.float32),
                          device=device)
    txt = torch.as_tensor(np.asarray(text_feats, np.float32), device=device)
    opt = adamw_init(params)
    named = dict(params.named_parameters())
    n = img.shape[0]
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=img.device)
        step_losses = []
        for s in range(0, n - batch_size + 1, batch_size):
            idx = order[s:s + batch_size]
            loss = contrastive_loss(params, img[idx], txt[idx])
            grads = torch.autograd.grad(loss, list(named.values()))
            adamw_update(params, dict(zip(named, grads)), opt, lr)
            step_losses.append(loss.detach())
        if step_losses:
            values = torch.stack(step_losses).cpu().tolist()
            if losses is not None:
                losses.extend(values)
            if not quiet:
                print(f"epoch {epoch}: loss "
                      f"{sum(values) / max(1, n // batch_size):.4f}")
    return params


@torch.no_grad()
def retrieval_accuracy(params: Mapping, image_feats, text_feats,
                       k: int = 5) -> float:
    """Top-k image -> text retrieval accuracy (cosine similarity)."""
    dev = params.logit_scale.device
    mapped = _unit(mapping_apply(params, torch.as_tensor(
        np.asarray(image_feats, np.float32), device=dev)))
    text = _unit(torch.as_tensor(np.asarray(text_feats, np.float32),
                                 device=dev))
    sims = mapped @ text.t()
    topk = torch.topk(sims, k, dim=1).indices
    hits = (topk == torch.arange(sims.shape[0], device=dev)[:, None]).any(1)
    return float(hits.float().mean())


def pca_2d(x: np.ndarray) -> np.ndarray:
    """The two leading principal components (numpy SVD)."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[:2].T).astype(np.float32)


@torch.no_grad()
def visualize_mapping(params: Mapping, image_feats, text_feats,
                      out_path: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The 2-D PCA of mapped image features and text features together;
    with ``out_path``, a scatter plot written there (matplotlib, imported
    only then). Returns (image points, text points)."""
    dev = params.logit_scale.device
    mapped = mapping_apply(params, torch.as_tensor(
        np.asarray(image_feats, np.float32), device=dev)).cpu().numpy()
    pts = pca_2d(np.concatenate([mapped, np.asarray(text_feats)], axis=0))
    n = mapped.shape[0]
    if out_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        ax.scatter(pts[:n, 0], pts[:n, 1], s=8, label="mapped image feats")
        ax.scatter(pts[n:, 0], pts[n:, 1], s=8, label="text feats")
        ax.legend()
        fig.savefig(out_path)
        plt.close(fig)
    return pts[:n], pts[n:]
