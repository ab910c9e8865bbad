"""Attention heat maps: the ``--eval`` mode.

Counterpart of ``multimodalpromptretrieval_tpu/train/visualize.py`` (the
reference's ``utils.py:127-284`` and ``main.py:365-380``): for each question
id in ``logs/correct_ids.txt`` (or one ``--qid``), run the model on that one
example, collect its attention maps, and for every (layer, head) save a
figure of the attention mass on each image token (the grid patches; the
ViT's token 0 is CLS and is skipped, the ResNet grid has none) over the
original image, under ``figures/<qid>/head<j>/attention<i>.pdf``.

The model runs as in the JAX package: ``combine_inputs``, ``t5_encode`` and
``t5_greedy_decode`` on the fp32 masters in one process's layout
(``exp.dense_params()``: the parameters themselves, or gathered from a
tensor-parallel rank's shards), no compute copy, then
:func:`~multimodalpromptretrieval_tpu_torch.models.t5.
t5_forward_with_attentions` over the generated ids. matplotlib and PIL are
imported by the figure function only: the maps need neither.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.models import mprgen
from multimodalpromptretrieval_tpu_torch.models.t5 import (
    t5_encode,
    t5_forward_with_attentions,
    t5_greedy_decode,
)


@torch.no_grad()
def attention_maps(exp, entry: dict, split_name: str = "test") -> dict:
    """One example through the model: ``encoder_attentions``,
    ``decoder_attentions``, ``cross_attentions`` (L, 1, H, Lq, Lk) fp32,
    ``logits``, the generated ``output_ids`` (1, 21), ``predicted_answer``
    and the prompt's ``input_ids``, as numpy (the JAX keys and two more)."""
    mcfg, dev = exp.model_cfg, exp.device
    ids = exp.encode_entry(entry, split_name)
    input_ids = torch.tensor([ids], dtype=torch.int32, device=dev)
    mask = torch.ones_like(input_ids)
    images = torch.as_tensor(np.stack([exp.images[entry["image_name"]]]),
                             device=dev)
    params = exp.dense_params()
    embeds, full_mask = mprgen.combine_inputs(params, mcfg, images,
                                              input_ids, mask)
    enc = t5_encode(params.t5, mcfg.t5, embeds, full_mask)
    out_ids = t5_greedy_decode(params.t5, mcfg.t5, enc, full_mask,
                               max_new_tokens=20)
    out = t5_forward_with_attentions(params.t5, mcfg.t5, embeds,
                                     full_mask, out_ids)
    maps = {k: out[k].cpu().numpy() for k in (
        "encoder_attentions", "decoder_attentions", "cross_attentions",
        "logits")}
    maps["output_ids"] = out_ids.cpu().numpy()
    maps["predicted_answer"] = exp.tokenizer.decode(
        maps["output_ids"][0], skip_special_tokens=True)
    maps["input_ids"] = ids
    return maps


def visualize_attn_weights(exp, entry: dict, *,
                           attn_type: str = "cross_attentions",
                           split_name: str = "test",
                           figures_root: str = "figures") -> int:
    """Save one heat-map PDF per (layer, head); returns the number
    written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches
    from PIL import Image

    maps = attention_maps(exp, entry, split_name)
    weights = maps[attn_type]  # (L, B, H, Lq, Lk)
    n_layers, _, n_heads = weights.shape[:3]
    n_image_tokens = exp.model_cfg.num_image_tokens
    # ViT prefix = [CLS, grid^2]; the ResNet prefix is the bare grid
    patch0 = 1 if exp.model_cfg.resnet is None else 0
    grid = int(round((n_image_tokens - patch0) ** 0.5))

    img_path = os.path.join(entry["dataroot"], "imgs", entry["image_name"])
    with Image.open(img_path) as im:
        original = im.resize((224, 224))
    xt = np.linspace(0, original.width, grid + 1)
    yt = np.linspace(0, original.height, grid + 1)
    gx, gy = xt[1] - xt[0], yt[1] - yt[0]

    written = 0
    for i in range(n_layers):
        for j in range(n_heads):
            if attn_type == "encoder_attentions":
                # attention FROM the patch tokens, averaged over the keys
                alphas = weights[i, 0, j,
                                 patch0:n_image_tokens].mean(axis=-1)
            else:  # decoder queries attending TO the patch keys
                alphas = weights[i, 0, j, :,
                                 patch0:n_image_tokens].mean(axis=0)
            span = alphas.max() - alphas.min()
            alphas = (alphas - alphas.min()) / (span if span > 0 else 1.0)

            fig, ax = plt.subplots(1, 2, figsize=(12, 5))
            ax[0].imshow(original)
            ax[0].set_title("Original Image")
            ax[0].set_xlabel(entry["question"])
            ax[1].imshow(original)
            ax[1].set_title("Attention Activation on Image Tokens")
            for r in range(grid):
                for c in range(grid):
                    ax[1].add_patch(patches.Rectangle(
                        (xt[c], yt[r]), gx, gy, linewidth=1, fill=True,
                        facecolor="black",
                        alpha=float(1 - alphas[grid * r + c])))
            ax[1].set_xlabel(
                f"Predicted answer: {maps['predicted_answer']}\n"
                f"Correct answer: {entry['answer']}")
            for a in ax:
                a.set_xticks([])
                a.set_yticks([])
            out_dir = os.path.join(figures_root, str(entry["question_id"]),
                                   f"head{j}")
            os.makedirs(out_dir, exist_ok=True)
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"attention{i}.pdf"))
            plt.close(fig)
            written += 1
    return written


def visualize_correct_ids(exp, qid: Optional[str] = None,
                          figures_root: str = "figures",
                          limit: Optional[int] = None) -> int:
    """What ``--eval`` runs: the cross-attention figures of one ``qid``,
    or of each id in ``{log_root}/correct_ids.txt`` (the first ``limit``).
    Returns the number of figures written."""
    test = exp.datasets["test"]
    if qid is not None:
        entry = test.get_question_by_id(qid)
        if entry is None:
            raise ValueError(f"question id {qid!r} not in the test set")
        return visualize_attn_weights(exp, entry, figures_root=figures_root)
    with open(os.path.join(exp.log_root, "correct_ids.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    if limit:
        ids = ids[:limit]
    n = 0
    for i, q in enumerate(ids):
        entry = test.get_question_by_id(q)
        if entry is None:
            continue
        n += visualize_attn_weights(exp, entry, figures_root=figures_root)
        exp.log(f"Finished image {i} out of {len(ids)}")
    return n
