"""Multimodal prompt-retrieval index (device-resident).

Counterpart of ``multimodalpromptretrieval_tpu/retrieval/index.py``, with
the reference behaviour it reproduces (dataset/VQAFeatureDataset.py):

  * index rows are ``concat(encode_image(img), encode_text(question))``,
    (N, 2 * embed_dim) fp32, embedded once through the port's CLIP;
  * similarity is Euclidean distance over the RAW embeddings (quirk #1),
    served by the L2 top-k kernel (``ops/topk.py``);
  * the training phase drops the single nearest neighbour (quirk #3);
  * majority vote over the top-k answers, ties to the first retrieved
    answer reaching the max count; certainty = maxcount / k maps onto six
    quantifier buckets ``buckets[int(certainty * 5)]`` (quirk #11);
  * hint strings ``"I believe the answer is {bucket} {answer}"`` or, with
    the quantifier off, ``"The most frequent answer is {answer}"``.

The on-disk index cache, ``extend`` and the other return modes of
``retrieve`` belong to the disk-dataset and evaluation paths and are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk

QUANTIFIER_BUCKETS = ["very unlikely", "unlikely", "maybe", "likely",
                      "very likely", "certainly"]


def majority_vote(answers: Sequence[str]) -> Tuple[str, float]:
    """(winner, certainty); the first answer in retrieval order that
    attains the maximal count wins."""
    counts: Dict[str, int] = {}
    for a in answers:
        counts[a] = counts.get(a, 0) + 1
    pred = max(counts, key=counts.get)
    certainty = max(counts.values()) / sum(counts.values())
    return pred, certainty


def quantifier_bucket(certainty: float) -> str:
    return QUANTIFIER_BUCKETS[int(certainty * (len(QUANTIFIER_BUCKETS) - 1))]


class RetrievalIndex:
    """(N, 2 * embed_dim) fp32 embeddings and their squared norms on the
    device, answer metadata on the host."""

    def __init__(self, embeddings, answers: List[str],
                 is_training_phase: bool = True, retrieval_k: int = 15,
                 device: Optional[torch.device] = None):
        self.embeddings = torch.as_tensor(
            embeddings, dtype=torch.float32, device=device).contiguous()
        self.index_sq = torch.sum(torch.square(self.embeddings), dim=-1)
        self.answers = list(answers)
        self.is_training_phase = is_training_phase
        self.retrieval_k = retrieval_k

    def __len__(self) -> int:
        return len(self.answers)

    @staticmethod
    def build(embed_fn: Callable[[np.ndarray, np.ndarray], torch.Tensor],
              entries: List[dict],
              image_batch_fn: Callable[[Sequence[str]], np.ndarray],
              clip_tokenize: Callable[[Sequence[str]], np.ndarray],
              batch_size: int = 64, is_training_phase: bool = True,
              retrieval_k: int = 15,
              device: Optional[torch.device] = None) -> "RetrievalIndex":
        """Embed the corpus (entry order) in batches and assemble the
        index. ``embed_fn(images, text_ids) -> (B, 2 * embed_dim)`` is the
        CLIP image (+) text encoder."""
        embs = []
        for s in range(0, len(entries), batch_size):
            chunk = entries[s:s + batch_size]
            images = image_batch_fn([e["image_name"] for e in chunk])
            text_ids = clip_tokenize([e["question"] for e in chunk])
            embs.append(embed_fn(images, text_ids).float())
        return RetrievalIndex(torch.cat(embs).to(device),
                              [e["answer"] for e in entries],
                              is_training_phase, retrieval_k, device)

    def topk(self, query_embeddings: torch.Tensor, k: Optional[int] = None):
        """(distances, indices) for the query batch; applies the
        training-phase self-match skip."""
        return l2_topk(query_embeddings, self.embeddings,
                       k or self.retrieval_k, index_sq=self.index_sq,
                       skip_first=self.is_training_phase)

    def retrieve(self, query_embeddings: torch.Tensor, *,
                 use_quantifier: bool = True,
                 k: Optional[int] = None) -> List[str]:
        """The hint string of each query (the default return mode of the
        JAX ``retrieve``): top-k, with the training-phase self-match skip,
        then :meth:`format_prompts`."""
        _, idx = self.topk(query_embeddings, k)
        return self.format_prompts(idx.cpu().numpy(),
                                   use_quantifier=use_quantifier)

    def format_prompts(self, idx, *, use_quantifier: bool = True
                       ) -> List[str]:
        """Majority vote + quantifier bucket over top-k indices -> hint
        strings (host side)."""
        prompts = []
        for row in np.asarray(idx):
            pred, certainty = majority_vote([self.answers[j] for j in row])
            if use_quantifier:
                prompts.append(
                    f"I believe the answer is {quantifier_bucket(certainty)}"
                    f" {pred}")
            else:
                prompts.append(f"The most frequent answer is {pred}")
        return prompts
