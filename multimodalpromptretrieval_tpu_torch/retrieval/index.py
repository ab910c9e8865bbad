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

Cache layout: ``{cache_dir}/{key}/index.npz`` with the embedding matrix,
answers and question info, the JAX package's format: a file written by
either package loads in the other. The caller derives the key
(``serving.ServingExperiment``).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.ops.topk import l2_topk
from multimodalpromptretrieval_tpu_torch.utils import savez_atomic

QUANTIFIER_BUCKETS = ["very unlikely", "unlikely", "maybe", "likely",
                      "very likely", "certainly"]
INFO_FIELDS = ("question_type", "question_id", "question")


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
    device, answers and question info on the host."""

    def __init__(self, embeddings, answers: List[str],
                 question_info: Dict[str, List[str]],
                 is_training_phase: bool = True, retrieval_k: int = 15,
                 device: Optional[torch.device] = None):
        self.embeddings = torch.as_tensor(
            embeddings, dtype=torch.float32, device=device).contiguous()
        self.index_sq = torch.sum(torch.square(self.embeddings), dim=-1)
        self.answers = list(answers)
        self.question_info = question_info
        self.is_training_phase = is_training_phase
        self.retrieval_k = retrieval_k

    def __len__(self) -> int:
        return len(self.answers)

    # -- build ---------------------------------------------------------------

    @staticmethod
    def build(embed_fn: Callable[[np.ndarray, np.ndarray], torch.Tensor],
              entries: List[dict],
              image_batch_fn: Callable[[Sequence[str]], np.ndarray],
              clip_tokenize: Callable[[Sequence[str]], np.ndarray],
              batch_size: int = 64, is_training_phase: bool = True,
              retrieval_k: int = 15, cache_path: Optional[str] = None,
              order: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> "RetrievalIndex":
        """Embed the corpus in batches and assemble the index, or load it
        from ``cache_path`` when that file exists (and write it there when
        it does not). ``embed_fn(images, text_ids) -> (B, 2 * embed_dim)``
        is the CLIP image (+) text encoder. ``order`` permutes the corpus
        (default: entry order)."""
        if cache_path and os.path.exists(cache_path):
            return RetrievalIndex.load(cache_path, is_training_phase,
                                       retrieval_k, device)
        idxs = list(order) if order is not None else list(range(len(entries)))
        embs = []
        answers: List[str] = []
        info: Dict[str, List[str]] = {f: [] for f in INFO_FIELDS}
        for s in range(0, len(idxs), batch_size):
            chunk = [entries[i] for i in idxs[s:s + batch_size]]
            images = image_batch_fn([e["image_name"] for e in chunk])
            text_ids = clip_tokenize([e["question"] for e in chunk])
            embs.append(embed_fn(images, text_ids).float())
            answers.extend(e["answer"] for e in chunk)
            for f in INFO_FIELDS:
                info[f].extend(e[f] for e in chunk)
        index = RetrievalIndex(torch.cat(embs).to(device), answers, info,
                               is_training_phase, retrieval_k, device)
        if cache_path:
            index.save(cache_path)
        return index

    def extend(self, other: "RetrievalIndex") -> None:
        """Append another corpus (``use_additional_retrieval_data``)."""
        if set(self.question_info) != set(other.question_info):
            # a skipped key would leave that info list shorter than the
            # answers, and a later retrieve(return_info=...) would fail
            raise ValueError(
                "question_info keys differ: "
                f"{sorted(self.question_info)} vs "
                f"{sorted(other.question_info)}")
        self.embeddings = torch.cat(
            [self.embeddings, other.embeddings.to(self.embeddings.device)])
        self.index_sq = torch.sum(torch.square(self.embeddings), dim=-1)
        self.answers.extend(other.answers)
        for k in self.question_info:
            self.question_info[k].extend(other.question_info[k])

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        savez_atomic(
            path, embeddings=self.embeddings.cpu().numpy(),
            answers=json.dumps(self.answers),
            question_info=json.dumps(self.question_info))

    @staticmethod
    def load(path: str, is_training_phase: bool = True,
             retrieval_k: int = 15, device: Optional[torch.device] = None
             ) -> "RetrievalIndex":
        with np.load(path, allow_pickle=False) as z:
            return RetrievalIndex(
                z["embeddings"], json.loads(str(z["answers"])),
                json.loads(str(z["question_info"])), is_training_phase,
                retrieval_k, device)

    # -- query ---------------------------------------------------------------

    def topk(self, query_embeddings: torch.Tensor, k: Optional[int] = None):
        """(distances, indices) for the query batch; applies the
        training-phase self-match skip."""
        return l2_topk(query_embeddings, self.embeddings,
                       k or self.retrieval_k, index_sq=self.index_sq,
                       skip_first=self.is_training_phase)

    def retrieve(self, query_embeddings: torch.Tensor, *,
                 return_ans: bool = False,
                 return_info: Optional[Sequence[str]] = None,
                 return_dists: bool = False, use_quantifier: bool = True,
                 k: Optional[int] = None):
        """The reference's ``retrieve_closest_qa_pairs`` return modes: the
        answers of the top k (``return_ans``), the named ``question_info``
        fields of each (``return_info``), (answers, distances) pairs
        (``return_dists``), or by default the hint string of each query."""
        dists, idx = self.topk(query_embeddings, k)
        idx = idx.cpu().numpy()
        answers = [[self.answers[j] for j in row] for row in idx]
        if return_ans:
            return answers
        if return_info:
            out = []
            for row in idx:
                info = []
                for j in row:
                    info.extend(self.question_info[f][j] for f in return_info)
                out.append(info)
            return out
        if return_dists:
            return list(zip(answers, dists.cpu().numpy()))
        return self.format_prompts(idx, use_quantifier=use_quantifier)

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
