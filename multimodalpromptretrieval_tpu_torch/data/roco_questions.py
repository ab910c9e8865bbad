"""Synthetic ROCO question generation (offline tooling).

The port's own copy of ``multimodalpromptretrieval_tpu/data/
roco_questions.py`` (host Python, no numpy): the same rows and CSVs from
the same seed. ``data/datasets.ROCODataset`` parses the CSVs, and
``serving.synthetic_roco`` builds the ROCO retrieval corpus from its rows.

Re-implements the reference's synthetic_data/ tooling
(generate_roco_questions.py:17-153, question_category.py:8-39,
question_category_specific.py:11-36): keyword/template banks matched
against each ROCO image's keyword list produce (q_type, image_id, question,
answer, question_type) rows used as an additional retrieval corpus.

RNG-visible behavior is preserved (global ``random`` seeded in each bucket
ctor; ``random.sample`` for template choice and wrong-answer sampling).
Reference quirks replicated deliberately behind ``faithful=True``
(SURVEY.md quirk #14):

  * the stratified split is computed and then DISCARDED — train.csv and
    test.csv both contain every row;
  * CSVs are written to the save-path ROOT even though a ``ROCO/`` subdir
    is created;
  * the shape bucket formats its template with the loop-leftover
    ``required_word`` (always the LAST required word, not the matched one).

``faithful=False`` fixes all three (split honored, files under ``ROCO/``,
matched organ in the template).
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

# keyword / template banks (generate_roco_questions.py:24-61)
ORGAN_SYSTEMS = ["Brain", "Chest", "Cardiovascular System",
                 "Respiratory System", "Gastrointestinal System",
                 "Cardiopulmonary System"]
ORGANS = ["Heart", "Lungs", "Lung", "Liver", "Breasts"]
ORGAN_SYSTEM_OPEN_T = [
    "What system is this pathology in?", "What organ system is pictured?",
    "What organ system is evaluated primarily?",
    "What is the organ system visualized?", "What organ system is displayed?"]
ORGAN_SYSTEM_CLOSED_T = [
    "Is this an image of the {}?", "Is this a study of the {}?",
    "Is this the {}?", "Is the {} shown?"]
ORGAN_OPEN_T = [
    "What part of the body is being imaged?",
    "What is the organ principally shown in this image?"]
ORGAN_CLOSED_T = [
    "Does the picture contain {}?", "Is this a study of the {}?",
    "Does the {} appear in this image?"]
MODALITIES = ["MRI", "CT", "T1", "T2", "X-ray", "Ultrasound", "Flair"]
MODALITY_OPEN_T = [
    "What type of medical image is this?", "What imaging modality was used?",
    "What is the modality by which the image was taken?",
    "What kind of scan is this?", "How was this image taken",
    "What type of imaging modality is seen in this image?",
    "What is the modality used?", "What imaging method was used?",
    "What modality is this?"]
MODALITY_CLOSED_T = ["Is this a {}?", "Is the image an {}?"]
PLANES = ["axial", "coronal", "supratentorial", "posteroanterior"]
PLANE_OPEN_T = [
    "What is the scanning plane of this image?",
    "In what plane is this image scanned?",
    "In what plane is this image oriented?",
    "Which plane is this image taken?",
    "What is the name of this image's plane?", "How is the image oriented?",
    "What image plane is this?", "What plane are we in?"]
PLANE_CLOSED_T = [
    "Is this a {} plane?", "Is this a {} image?", "Is this a {} section?",
    "Was this image taken in {} format?"]
PRESENCE = ["pneumothorax", "fracture", "hernia", "edema", "hematoma",
            "cyst", "hemorrhage", "lymphadenopathy", "pneumoperitoneum"]
PRESENCE_CLOSED_T = ["Is there evidence of a {}?", "Is there a {}",
                     "Is a {} present?"]
SHAPE_REQUIRED = ["kidney", "larynx", "treachea", "spine", "spleen"]
SHAPE_KEYWORDS = ["irregular", "oval", "circular"]
SHAPE_TEMPLATES = ["What is the shape of the {} in this picture?"]


class QuestionBucket:
    """Generic keyword bucket (question_category.py:8-39). Open questions
    answer with the matched keyword; closed ones flip a fair coin between a
    "yes" with the keyword and a "no" with a sampled wrong keyword."""

    def __init__(self, q_category: str, keywords: Sequence[str],
                 templates: Sequence[str], q_type: str = "open",
                 seed: int = 88):
        random.seed(seed)  # reference seeds the GLOBAL rng per ctor
        self.q_category = q_category
        self.keywords = list(keywords)
        self.templates = list(templates)
        self.q_type = q_type

    def get_question(self, picture_keywords: Sequence[str]
                     ) -> Optional[Tuple[List[str], List[str]]]:
        questions: List[str] = []
        answers: List[str] = []
        for keyword in self.keywords:
            keyword = keyword.split()[0].lower()
            if keyword not in picture_keywords:
                continue
            if self.q_type == "open":
                questions.append(random.sample(self.templates, 1)[0])
                answers.append(keyword)
            elif random.random() > 0.5:
                questions.append(
                    random.sample(self.templates, 1)[0].format(keyword))
                answers.append("yes")
            else:
                wrong = random.sample(
                    [x for x in self.keywords if x != keyword], 1)[0]
                questions.append(
                    random.sample(self.templates, 1)[0].format(wrong))
                answers.append("no")
        return (questions, answers) if questions else None


class SpecificQuestionBucket(QuestionBucket):
    """Shape bucket: requires an organ word co-present with a shape keyword
    (question_category_specific.py:11-36)."""

    def __init__(self, required_words: Sequence[str], q_category: str,
                 keywords: Sequence[str], templates: Sequence[str],
                 q_type: str = "open", seed: int = 88,
                 faithful: bool = True):
        super().__init__(q_category, keywords, templates, q_type, seed)
        self.required_words = list(required_words)
        self.faithful = faithful

    def get_question(self, picture_keywords):
        questions: List[str] = []
        answers: List[str] = []
        for keyword in self.keywords:
            keyword = keyword.split()[0].lower()
            if keyword not in picture_keywords:
                continue
            matched = None
            for required_word in self.required_words:
                if required_word in picture_keywords:
                    matched = required_word
            if not matched:
                continue
            if self.q_type == "open":
                # quirk #14: the reference formats with the loop-leftover
                # variable — always the LAST required word, not the match
                word = self.required_words[-1] if self.faithful else matched
                questions.append(
                    random.sample(self.templates, 1)[0].format(word))
                answers.append(keyword)
        return (questions, answers) if questions else None


def default_buckets(seed: int = 88, faithful: bool = True,
                    include_extra: bool = False) -> List[QuestionBucket]:
    """The reference's active bucket list (generate_roco_questions.py:91):
    ORGAN_SYSTEM_OPEN twice, no presence/shape in the default run.
    ``include_extra`` adds the defined-but-unused presence + shape buckets."""
    b = [
        QuestionBucket("Organ", ORGAN_SYSTEMS, ORGAN_SYSTEM_OPEN_T, "open", seed),
        QuestionBucket("Organ", ORGAN_SYSTEMS, ORGAN_SYSTEM_OPEN_T, "open", seed),
        QuestionBucket("Organ", ORGANS, ORGAN_OPEN_T, "open", seed),
        QuestionBucket("Organ", ORGANS, ORGAN_CLOSED_T, "closed", seed),
        QuestionBucket("Modality", MODALITIES, MODALITY_OPEN_T, "open", seed),
        QuestionBucket("Modality", MODALITIES, MODALITY_CLOSED_T, "closed", seed),
        QuestionBucket("Plane", PLANES, PLANE_OPEN_T, "open", seed),
        QuestionBucket("Plane", PLANES, PLANE_CLOSED_T, "closed", seed),
    ]
    if include_extra:
        b.append(QuestionBucket("Presence", PRESENCE, PRESENCE_CLOSED_T,
                                "closed", seed))
        b.append(SpecificQuestionBucket(SHAPE_REQUIRED, "Shape",
                                        SHAPE_KEYWORDS, SHAPE_TEMPLATES,
                                        "open", seed))
    return b


def read_roco_metadata(roco_root: str):
    """captions.txt / keywords.txt tab format
    (generate_roco_questions.py:97-110)."""
    base = os.path.join(roco_root, "roco-dataset", "data", "train",
                        "radiology")
    captions: Dict[str, str] = {}
    with open(os.path.join(base, "captions.txt")) as f:
        for line in f:
            if "\t" in line:
                rid, cap = line.split("\t", 1)
                captions[rid] = cap
    keywords: Dict[str, List[str]] = {}
    with open(os.path.join(base, "keywords.txt")) as f:
        for line in f:
            if "\t" in line:
                rid, k = line.split("\t", 1)
                # reference-exact (generate_roco_questions.py:95-96), BUGS
                # INCLUDED: the id was already split off, so the extra
                # [1:] drops the first real keyword of every image, and
                # the last keyword keeps its trailing "\n" (no strip) so
                # it can never match a bucket keyword. Replicated because
                # the emitted question set and the RNG stream that
                # follows are defined by this exact behavior.
                keywords[rid] = [x.lower() for x in k.split("\t")][1:]
    return captions, keywords, os.path.join(base, "images")


def generate_questions(keywords: Dict[str, List[str]], images_path: str,
                       buckets: Optional[List[QuestionBucket]] = None,
                       seed: int = 88, faithful: bool = True,
                       require_images: bool = True) -> List[List[str]]:
    """Rows of (q_type_category, image_id, question, answer, open/closed)."""
    buckets = buckets if buckets is not None else default_buckets(seed, faithful)
    rows: List[List[str]] = []
    for rid in keywords:
        if require_images and not os.path.exists(
                os.path.join(images_path, rid + ".jpg")):
            continue
        for bucket in buckets:
            out = bucket.get_question(keywords[rid])
            if out is None:
                continue
            qs, ans = out
            for q, a in zip(qs, ans):
                rows.append([bucket.q_category, rid + ".jpg", q, a,
                             bucket.q_type])
    return rows


def stratified_split(rows: List[List[str]], split_fraction: float = 0.2,
                     seed: int = 88) -> List[int]:
    """Per-category random.sample split (generate_roco_questions.py:121-135)."""
    random.seed(seed)
    by_cat: Dict[str, List[int]] = {}
    for i, row in enumerate(rows):
        by_cat.setdefault(row[0], []).append(i)
    indices: List[int] = []
    for cat in by_cat:
        indices.extend(random.sample(
            by_cat[cat], int(len(by_cat[cat]) * split_fraction)))
    return indices


def write_csvs(rows: List[List[str]], save_path: str,
               faithful: bool = True, seed: int = 88) -> Tuple[str, str]:
    """Write train.csv / test.csv. ``faithful`` replicates quirk #14: the
    split is discarded (both files hold ALL rows) and the files go to the
    save-path root while an empty ROCO/ dir is created."""
    cols = ["q_type", "image_id", "question", "answer", "question_type"]
    os.makedirs(os.path.join(save_path, "ROCO"), exist_ok=True)
    if faithful:
        train_rows = test_rows = rows
        out_dir = save_path
    else:
        idx = set(stratified_split(rows, seed=seed))
        train_rows = [r for i, r in enumerate(rows) if i in idx]
        test_rows = [r for i, r in enumerate(rows) if i not in idx]
        out_dir = os.path.join(save_path, "ROCO")
    paths = []
    for name, data in (("train.csv", train_rows), ("test.csv", test_rows)):
        p = os.path.join(out_dir, name)
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            w.writerows(data)
        paths.append(p)
    return paths[0], paths[1]


def generate_roco_dataset(roco_root: str, save_path: str, *, seed: int = 88,
                          faithful: bool = True) -> List[List[str]]:
    """Full pipeline of the reference script's __main__."""
    _, keywords, images_path = read_roco_metadata(roco_root)
    rows = generate_questions(keywords, images_path, seed=seed,
                              faithful=faithful)
    write_csvs(rows, save_path, faithful=faithful, seed=seed)
    return rows
