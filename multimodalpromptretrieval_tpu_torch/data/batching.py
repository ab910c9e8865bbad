"""Fixed-shape padded batching (static-shape replacement for "longest").

The reference tokenizes with ``padding="longest"`` per batch
(architectures/T5VisionModel.py:161-167) — dynamic shapes that would force
a new shape per batch. Here token ids are padded to a small set of
static bucket widths (multiples of ``bucket_multiple``, capped at
``max_source_length``), the widths the JAX package compiles once each.
Truncation semantics are unchanged (max_source_length cut, EOS preserved by
the tokenizer); padding past the longest row only adds masked positions,
which cannot change encoder outputs at valid positions (attention masks) —
EM parity is preserved, and both packages see the same batches.

The final short batch is padded up to the batch size with repeated rows and
a ``valid`` mask so every step sees identical shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def bucket_width(length: int, multiple: int = 32, maximum: int = 512,
                 minimum: int = 32) -> int:
    w = max(minimum, -(-length // multiple) * multiple)
    return min(w, maximum)


def pad_ids(rows: Sequence[Sequence[int]], width: int, pad_id: int = 0):
    """(ids, mask) as (B, width) int32 arrays; rows longer than ``width``
    are truncated (the tokenizer already applied max_source_length)."""
    B = len(rows)
    ids = np.full((B, width), pad_id, np.int32)
    mask = np.zeros((B, width), np.int32)
    for i, r in enumerate(rows):
        r = list(r)[:width]
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return ids, mask


def pad_rows(mat: np.ndarray, lens: np.ndarray, width: int,
             pad_id: int = 0):
    """:func:`pad_ids` for pre-batched rows — the ``(N, W0) ids +
    lengths`` shape tokenizer ``encode_rows`` produces. Pure numpy (no
    per-row Python loop: the serving host path pads 512 rows per chunk).
    """
    B = mat.shape[0]
    ids = np.full((B, width), pad_id, np.int32)
    w = min(width, mat.shape[1])
    ids[:, :w] = mat[:, :w]
    mask = (np.arange(width)[None, :]
            < np.minimum(lens, width)[:, None]).astype(np.int32)
    ids[mask == 0] = pad_id
    return ids, mask


def encode_unique_chunks(items: Sequence[Any], fetch, upload, step,
                         batch_size: int, n_out: int = 1,
                         first_chunk_guard=None):
    """Run a per-batch encoder once per item, in padded chunks.

    The one loop behind the device-side staging caches
    (``TrainingExperiment.build_vision_token_cache`` and
    ``_query_embeddings``): stack ``fetch(item)`` for each chunk of
    ``batch_size`` items (tail padded by repeating the last item),
    ``upload`` the stack, run ``step`` on it, slice off the pad rows, and
    concatenate each output into a device-resident table.

    ``items`` are unique keys (the caller dedupes). ``fetch(item)`` may
    return a tuple for multi-input encoders (each position is stacked
    into its own batch array and ``step`` receives the tuple).
    ``step(x)`` returns a tensor, or a tuple of ``n_out`` tensors, with
    leading axis ``batch_size``. ``first_chunk_guard(first_rows) -> True``
    aborts (size-cap checks). Returns a tuple of ``n_out`` tables with
    leading axis ``len(items)``, or None (guard tripped / no items).
    """
    if not items:
        return None
    outs: List[list] = [[] for _ in range(n_out)]
    for s in range(0, len(items), batch_size):
        chunk = list(items[s:s + batch_size])
        padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
        fetched = [fetch(it) for it in padded]
        if isinstance(fetched[0], tuple):
            x = tuple(np.stack(col) for col in zip(*fetched))
        else:
            x = np.stack(fetched)
        res = step(upload(x))
        if n_out == 1:
            res = (res,)
        for o, r in zip(outs, res):
            o.append(r[:len(chunk)])
        if s == 0 and first_chunk_guard is not None \
                and first_chunk_guard(outs[0][0]):
            return None
    return tuple(p[0] if len(p) == 1 else torch.cat(p) for p in outs)


def pad_labels(rows: Sequence[Sequence[int]], width: int):
    """Target ids padded with -100 (the CE ignore index, HF parity)."""
    B = len(rows)
    out = np.full((B, width), -100, np.int64)
    for i, r in enumerate(rows):
        r = list(r)[:width]
        out[i, : len(r)] = r
    return out


@dataclasses.dataclass
class Batch:
    """Host-side batch; ``valid`` marks real rows (False = fill rows added
    to reach the static batch size)."""

    arrays: Dict[str, np.ndarray]
    entries: List[dict]
    valid: np.ndarray

    def __len__(self):
        return int(self.valid.sum())


def make_batches(
    entries: List[dict],
    batch_size: int,
    *,
    encode_fn,
    image_fn=None,
    label_fn=None,
    target_fn=None,
    array_fns: Optional[Dict[str, Any]] = None,
    shuffle_rng: Optional[np.random.Generator] = None,
    bucket_multiple: int = 32,
    max_source_length: int = 512,
) -> List[Batch]:
    """Assemble fixed-shape batches.

    encode_fn(entry) -> list[int] token ids for the prompt;
    image_fn(entries) -> (B, 3, R, R) float32;
    target_fn(entry) -> list[int] answer token ids (generative variants);
    label_fn(entry) -> int class label (head variants).
    """
    order = list(range(len(entries)))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)
    batches: List[Batch] = []
    for s in range(0, len(order), batch_size):
        chunk_idx = order[s : s + batch_size]
        chunk = [entries[i] for i in chunk_idx]
        n_valid = len(chunk)
        while len(chunk) < batch_size:  # static batch shape
            chunk.append(chunk[-1])
        token_rows = [encode_fn(e) for e in chunk]
        width = bucket_width(max(len(r) for r in token_rows),
                             bucket_multiple, max_source_length)
        ids, mask = pad_ids(token_rows, width)
        arrays: Dict[str, np.ndarray] = {
            "input_ids": ids, "text_mask": mask}
        if image_fn is not None:
            arrays["images"] = image_fn(chunk)
        for name, fn in (array_fns or {}).items():
            arrays[name] = fn(chunk)
        if target_fn is not None:
            target_rows = [target_fn(e) for e in chunk]
            twidth = bucket_width(max(len(r) for r in target_rows),
                                  8, 128, 8)
            labels = pad_labels(target_rows, twidth)
            # fill rows (duplicated last entry) are masked out of the CE
            # entirely: the token-mean then equals the reference's SHORT
            # final batch — fill rows contribute no loss and no gradient
            labels[n_valid:] = -100
            arrays["labels"] = labels
        if label_fn is not None:
            class_labels = np.asarray(
                [label_fn(e) for e in chunk], np.int32)
            class_labels[n_valid:] = -100  # same rule for the head CE
            arrays["class_labels"] = class_labels
        valid = np.zeros((batch_size,), bool)
        valid[:n_valid] = True
        batches.append(Batch(arrays, chunk, valid))
    return batches
