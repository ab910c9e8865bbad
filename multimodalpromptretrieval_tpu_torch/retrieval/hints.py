"""Device-side prompt construction: pre-tokenized retrieval-hint tables.

Counterpart of ``multimodalpromptretrieval_tpu/retrieval/hints.py``, with
the speculative decode's draft tables. The corpus
is frozen when the server is built, so every hint the pipeline can produce
-- the corpus' distinct answers x six quantifier buckets, or the plain
form -- is tokenized once into a device table. A serve chunk then runs
retrieval -> majority vote -> hint splice -> T5 on the device with no
index fetch and no host re-tokenization.

Token parity is exact: hints are tokenized with ``encode_continuation``
and the fast path engages only when ``concat_safe`` proves the question ->
hint junction factorizes (``serve.MPRServer`` checks each request).
In-graph vote: first-retrieved tie-breaking, bucket ``(maxcount * 5) // k``
(equal to ``int(certainty * 5)`` for every maxcount <= k <= 64), hint
appended right after the question (quirk #12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.retrieval.index import (
    QUANTIFIER_BUCKETS,
    RetrievalIndex,
)


@dataclass
class HintTables:
    """Device-resident hint tokenization of a frozen retrieval corpus.

    ``aid[j]``     dense answer id of corpus entry j (first-occurrence order);
    ``hint_ids``   (R, Hmax) int32 continuation ids, row ``aid * 6 + bucket``
                   (quantifier) or ``aid`` (plain);
    ``hint_len``   (R,) int32 valid lengths;
    ``first_char`` the first character of every hint, for the per-request
                   boundary check.
    """

    aid: torch.Tensor
    hint_ids: torch.Tensor
    hint_len: torch.Tensor
    first_char: str

    @property
    def max_hint_len(self) -> int:
        return int(self.hint_ids.shape[1])


def hint_strings(answer: str, use_quantifier: bool) -> List[str]:
    """The hint strings corpus answer ``answer`` can produce."""
    if use_quantifier:
        return [f"I believe the answer is {b} {answer}"
                for b in QUANTIFIER_BUCKETS]
    return [f"The most frequent answer is {answer}"]


def build_hint_tables(index: RetrievalIndex, tokenizer,
                      use_quantifier: bool = True) -> Optional[HintTables]:
    """Tokenize every possible hint over ``index``'s answers; None (fast
    path unavailable) when a hint contains a user-added token."""
    first: dict = {}
    for a in index.answers:
        first.setdefault(a, len(first))
    distinct = list(first)
    added = list(getattr(tokenizer, "added", {}))
    rows: List[List[int]] = []
    for a in distinct:
        for h in hint_strings(a, use_quantifier):
            # the full-string encoder splits on added tokens anywhere in
            # the hint, which encode_continuation does not
            if any(tok in h for tok in added):
                return None
            rows.append(tokenizer.encode_continuation(h))
    if not rows:
        return None
    H = max(len(r) for r in rows)
    if H == 0:
        return None
    ids = np.zeros((len(rows), H), np.int32)
    lens = np.zeros((len(rows),), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        lens[i] = len(r)
    aid = np.asarray([first[a] for a in index.answers], np.int32)
    dev = index.embeddings.device
    return HintTables(
        aid=torch.as_tensor(aid, device=dev),
        hint_ids=torch.as_tensor(ids, device=dev),
        hint_len=torch.as_tensor(lens, device=dev),
        first_char=hint_strings(distinct[0], use_quantifier)[0][0])


@dataclass
class DraftTables:
    """Per-answer drafts of the hint-draft speculative decode
    (``models/t5.t5_spec_greedy_decode``): row ``a`` holds
    ``tokenizer.encode(answer_a)`` (the label tokenization, EOS included),
    zero-padded, indexed by the same dense answer id as
    :class:`HintTables`, so the vote winner gathers its draft. A draft only
    changes the speed, never the answer."""

    ids: torch.Tensor  # (n_distinct_answers, A) int32


def build_draft_tables(index: RetrievalIndex, tokenizer,
                       max_length: int = 20) -> Optional[DraftTables]:
    """Tokenize every distinct corpus answer into a draft row; None for an
    empty corpus."""
    first: dict = {}
    for a in index.answers:
        first.setdefault(a, len(first))
    if not first:
        return None
    rows = [tokenizer.encode(a, max_length=max_length) for a in first]
    ids = np.zeros((len(rows), max(1, max(len(r) for r in rows))), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return DraftTables(ids=torch.as_tensor(ids,
                                           device=index.embeddings.device))


def vote_rows(aid_k: torch.Tensor, use_quantifier: bool) -> torch.Tensor:
    """In-graph majority vote over the top-k answer ids (B, k), in
    retrieval-rank order -> hint-table rows. Winner: the answer whose
    FIRST rank is smallest among those with the maximal count."""
    k = aid_k.shape[1]
    eq = aid_k[:, :, None] == aid_k[:, None, :]            # (B, k, k)
    counts = torch.sum(eq, dim=2, dtype=torch.int32)        # (B, k)
    ranks = torch.arange(k, dtype=torch.int32, device=aid_k.device)
    first_rank = torch.amin(
        torch.where(eq, ranks[None, None, :], k), dim=2)    # (B, k)
    maxc = torch.amax(counts, dim=1, keepdim=True)          # (B, 1)
    pos = torch.argmin(
        torch.where(counts == maxc, first_rank, k), dim=1)  # (B,)
    winner = torch.gather(aid_k, 1, pos[:, None])[:, 0]
    if not use_quantifier:
        return winner
    bucket = (maxc[:, 0] * 5) // k
    return winner * len(QUANTIFIER_BUCKETS) + bucket


def splice_hints(q_ids: torch.Tensor, q_len: torch.Tensor,
                 h_ids: torch.Tensor, h_len: torch.Tensor, eos_id: int,
                 pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full prompt rows ``[question | hint | EOS | pad]`` and their mask.

    ``q_ids`` (B, W): question ids padded to the final width (no EOS);
    ``h_ids`` (B, Hmax): gathered hint rows. Rows that overflow W are
    truncated as ``spm.encode(..., max_length=W)`` truncates: content is
    dropped and the row still ends with EOS."""
    W = q_ids.shape[1]
    j = torch.arange(W, dtype=torch.int32, device=q_ids.device)[None, :]
    ql = q_len[:, None].to(torch.int32)
    hl = h_len[:, None].to(torch.int32)
    off = j - ql
    hr = torch.gather(h_ids, 1,
                      torch.clamp(off, 0, h_ids.shape[1] - 1).long())
    eos_pos = torch.clamp(ql + hl, max=W - 1)
    content = torch.where(off < 0, q_ids, hr)
    ids = torch.where(j < eos_pos, content,
                      torch.where(j == eos_pos, eos_id, pad_id))
    mask = (j <= eos_pos).to(torch.int32)
    return ids.to(torch.int32), mask
