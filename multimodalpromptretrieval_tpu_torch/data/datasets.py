"""Dataset parsers with reference-exact entry normalization.

A copy of ``multimodalpromptretrieval_tpu/data/datasets.py`` (the port
shares no module with the JAX package); the fuzzy label goes through the
port's own ``native``. Mirrors dataset/VQAFeatureDataset.py,
dataset/SLAKE.py, dataset/VQA_RAD.py, dataset/ROCO.py and utils.py:64-122
of the reference:

  * SLAKE JSON: keep ``q_lang == "en"`` only, lowercase question/answer,
    fix the ``'closed '`` answer_type typo, drop empty answers
    (VQAFeatureDataset.py:60-84);
  * VQA_RAD JSON: one entry per comma-separated question_type, mapped
    through the typo-tolerant ``qtype_map`` (VQA_RAD.py:6-53); empty answers
    are NOT dropped (reference behavior);
  * ROCO CSV: question_id = row index + 100000 (ROCO.py:16-31);
  * ``filter_max_answers`` halves the cap between open and closed answers
    and removes the intersection from open (VQAFeatureDataset.py:86-96);
  * ``get_stratified_split`` replicates the reference's ``random.seed(88)``
    + per-task ``random.sample`` exactly (VQAFeatureDataset.py:249-261);
  * ``create_ans2label`` builds the label vocabulary over
    train ∪ validate ∪ test (utils.py:64-76 — quirk #8);
  * ``load_dataset`` factory with the VQA_RAD validate→train aliasing,
    COMBINED, and "+"-joined composition (utils.py:89-122).

Image tensors live in an npz-backed cache (images.py), preprocessed on
the device: the analogue of the reference's ``images_{split}.pkl``.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

VQA_RAD_QTYPE_MAP = {
    "PRES": "Presence",
    "ABN": "Abnormality",
    "MODALITY": "Modality",
    "ORGAN": "Organ",
    "PLANE": "Plane",
    "OTHER": "Other",
    "SIZE": "Size",
    "ATTRIB": "Attribute",
    "COLOR": "Color",
    "ATRIB": "Attribute",   # dataset typo
    "PRSE": "Presence",     # dataset typo
    "POS": "Position",
    "COUNT": "Quantity",
    "Other": "Other",
}


class VQADataset:
    """Entry list + label utilities (functional analogue of the torch
    Dataset base class; batching is done by the driver, not __getitem__)."""

    def __init__(self, name: str, dataroot: str):
        self.name = name
        self.dataroot = dataroot
        self.entries: List[Dict] = self._load_dataset(dataroot, name)
        # Entries remember their source root so COMBINED / "+"-merged
        # datasets resolve images correctly (the reference merges the
        # preloaded image dicts instead, utils.py:109-110).
        for e in self.entries:
            e["dataroot"] = dataroot
        self.images = None  # attached lazily by ImageCache

    @classmethod
    def from_entries(cls, name: str, entries: List[Dict]) -> "VQADataset":
        """A dataset over entries already parsed (an in-memory split)."""
        ds = cls.__new__(cls)
        ds.name, ds.dataroot, ds.entries, ds.images = name, None, entries, None
        return ds

    # -- parsing --------------------------------------------------------------

    def _load_dataset(self, dataroot: str, name: str) -> List[Dict]:
        """SLAKE-format JSON (the base format)."""
        with open(os.path.join(dataroot, name + ".json")) as f:
            samples_all = json.load(f)
        entries = []
        for entry in samples_all:
            if entry.get("q_lang") != "en":
                continue
            sample = {
                "image_name": entry["img_name"],
                "question_id": str(entry["qid"]),
                "question": entry["question"].lower(),
                "answer": entry["answer"].lower(),
                "task": entry["content_type"],
                "question_type": entry["answer_type"].lower(),
            }
            if sample["question_type"] == "closed ":
                sample["question_type"] = "closed"
            if entry["answer"] == "":
                continue
            entries.append(sample)
        return entries

    # -- label utilities -------------------------------------------------------

    def add_labels(self, ans2label: Dict[str, int]) -> None:
        for e in self.entries:
            e["label"] = ans2label[e["answer"]]

    def get_closest_label(self, answer: str) -> int:
        """Fuzzy label via difflib ratio over ALL entries — the test-time
        string-match credit (VQAFeatureDataset.py:55-58, quirk #13). The
        reference's ``sorted(..., reverse=True)[0]`` is stable, so among
        ties the earliest entry wins; native.closest_index (C++ difflib
        port) keeps that tie-break and replaces the O(N·len²) Python scan."""
        from multimodalpromptretrieval_tpu_torch.native import closest_index

        answers = self._answer_list()
        return self.entries[closest_index(answer, answers)]["label"]

    def _answer_list(self) -> List[str]:
        cached = getattr(self, "_answers_cache", None)
        if cached is None or len(cached) != len(self.entries):
            cached = [e["answer"] for e in self.entries]
            self._answers_cache = cached
        return cached

    def filter_max_answers(self, num: int,
                           answer_set: Optional[set] = None) -> Sequence[str]:
        if answer_set is None:
            open_a = {e["answer"] for e in self.entries
                      if e["question_type"] == "open"}
            closed_a = {e["answer"] for e in self.entries
                        if e["question_type"] == "closed"}
            open_a -= set.intersection(open_a, closed_a)
            answer_set = (sorted(open_a)[:num // 2]
                          + sorted(closed_a)[:num // 2])
        self.entries = [e for e in self.entries if e["answer"] in answer_set]
        return answer_set

    def filter(self, qtype_list: Sequence[str],
               limit_num_examples: float = float("inf")) -> None:
        counts: Dict[str, int] = {}
        new_entries = []
        for e in self.entries:
            if e["task"] in qtype_list:
                counts.setdefault(e["task"], 0)
                if counts[e["task"]] >= limit_num_examples:
                    continue
                counts[e["task"]] += 1
                new_entries.append(e)
        self.entries = new_entries

    def get_question_by_id(self, qid: str) -> Optional[Dict]:
        for e in self.entries:
            if e["question_id"] == str(qid).strip():
                return e
        return None

    def get_stratified_split(self, split_fraction: float = 0.2,
                             seed: int = 88) -> List[int]:
        """Reference-exact RNG sequence (VQAFeatureDataset.py:249-261)."""
        indices: List[int] = []
        random.seed(seed)
        category_to_index: Dict[str, List[int]] = {}
        for i, e in enumerate(self.entries):
            category_to_index.setdefault(e["task"], []).append(i)
        for category in category_to_index:
            indices.extend(random.sample(
                category_to_index[category],
                int(len(category_to_index[category]) * split_fraction)))
        return indices

    def __len__(self) -> int:
        return len(self.entries)

    def summary(self) -> str:
        q_types: Dict[str, int] = {}
        q_cats: Dict[str, int] = {}
        for e in self.entries:
            q_types[e["question_type"]] = q_types.get(e["question_type"], 0) + 1
            q_cats[e["task"]] = q_cats.get(e["task"], 0) + 1
        return (f"Question types: {q_types}\n"
                f"Question categories: {q_cats}\n")


class SLAKEDataset(VQADataset):
    """SLAKE JSON is the base format (dataset/SLAKE.py)."""


class VQARADDataset(VQADataset):
    """VQA-RAD: one entry per comma-separated question_type
    (dataset/VQA_RAD.py:29-53)."""

    def _load_dataset(self, dataroot: str, name: str) -> List[Dict]:
        with open(os.path.join(dataroot, f"{name}.json")) as f:
            samples_all = json.load(f)
        entries = []
        for entry in samples_all:
            for qtype in str(entry["question_type"]).split(", "):
                sample = {
                    "image_name": entry["image_name"],
                    "question_id": str(entry["qid"]),
                    "question": entry["question"].lower(),
                    "answer": str(entry["answer"]).lower(),
                    "task": VQA_RAD_QTYPE_MAP[qtype],
                    "question_type": entry["answer_type"].lower(),
                }
                if sample["question_type"] == "closed ":
                    sample["question_type"] = "closed"
                entries.append(sample)
        return entries


class ROCODataset(VQADataset):
    """Synthetic ROCO CSV (dataset/ROCO.py:16-31)."""

    def __init__(self, name: str, dataroot: str, mode: str = "train",
                 clip_type: str = "PubMedClip"):
        super().__init__(name, dataroot)
        self.mode = mode
        self.clip_type = clip_type

    def _load_dataset(self, dataroot: str, name: str) -> List[Dict]:
        import csv

        entries = []
        with open(os.path.join(dataroot, f"{name}.csv"), newline="") as f:
            for idx, row in enumerate(csv.DictReader(f)):
                entries.append({
                    "image_name": row["image_id"],
                    "question": row["question"].lower(),
                    "answer": str(row["answer"]).lower(),
                    "task": row["q_type"],
                    "question_id": str(idx + 100000),
                    "question_type": row["question_type"].lower(),
                })
        return entries


def create_ans2label(*datasets: VQADataset):
    """Label space over the union of all given splits (utils.py:64-76)."""
    answers = []
    for ds in datasets:
        answers.extend(e["answer"].lower() for e in ds.entries)
    possible = sorted(set(answers))
    label2ans = {i: a for i, a in enumerate(possible)}
    ans2label = {a: i for i, a in enumerate(possible)}
    return label2ans, ans2label


def load_dataset(data_folder: str, data_name: str, split: str) -> VQADataset:
    """utils.py:89-122 parity, incl. VQA_RAD validate→train aliasing."""
    if data_name == "VQA_RAD":
        s = "train" if split == "validate" else split
        return VQARADDataset(s, os.path.join(data_folder, data_name))
    if data_name == "SLAKE":
        return SLAKEDataset(split, os.path.join(data_folder, "SLAKE"))
    if data_name == "ROCO":
        s = "train" if split == "train" else "test"
        return ROCODataset(s, os.path.join(data_folder, "ROCO"))
    if data_name == "COMBINED":
        ds = SLAKEDataset(split, os.path.join(data_folder, "SLAKE"))
        s = "train" if split == "validate" else split
        rad = VQARADDataset(s, os.path.join(data_folder, "VQA_RAD"))
        ds.entries.extend(rad.entries)
        return ds
    if "+" in data_name:
        combined = None
        for dset in data_name.split("+"):
            new = load_dataset(data_folder, dset, split)
            if combined is None:
                combined = new
            else:
                combined.entries.extend(new.entries)
        return combined
    raise ValueError(f"unknown dataset {data_name}")
