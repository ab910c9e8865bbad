"""The synthetic SLAKE traffic, made from ``--seed``.

A frozen copy of the port's generator, so that later changes to the program
cannot move the yardstick: ``_COLORS``, ``_SHAPES``, ``_COUNT_WORDS``,
``_open_qa`` and ``_draw`` from
``multimodalpromptretrieval_tpu_torch/data/synthetic.py``;
``synthetic_slake``, ``normalize_image`` and ``tokenizer_corpus`` from
``multimodalpromptretrieval_tpu_torch/serving.py``. The draws are the same:
one ``random.Random(seed)`` walks the splits in order, and each image draws
its shape, color, count, positions and question probe.

A workload file names this generator under ``traffic.generator`` and gives
its parameters: ``n_train`` (the retrieval corpus), ``n_validate``,
``n_test`` (the served questions, 3 an image), ``answer_style`` ("short"
or "open") and ``image_size``. Every seed gives the same number of images
and questions from the same templates; only the drawn content differs.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

_COLORS: Dict[str, Tuple[int, int, int]] = {
    "red": (220, 40, 40),
    "green": (40, 200, 60),
    "blue": (50, 80, 230),
    "yellow": (230, 220, 50),
}
_SHAPES = ("circle", "square", "cross")
_COUNT_WORDS = {1: "one", 2: "two", 3: "three"}

# CLIP's preprocess normalization constants (clip/clip.py)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _open_qa(shape: str, color_name: str, count: int,
             rng: random.Random) -> List[tuple]:
    """Open-ended QA pairs with multi-token answers (2-8 T5 tokens) and
    long questions."""
    plural = "s" if count > 1 else ""
    probe = rng.choice(_SHAPES)
    return [
        ("what does the image show overall, including the number, color "
         "and form of the findings present?",
         f"{_COUNT_WORDS[count]} {color_name} {shape}{plural} on a plain "
         "light background",
         "Shape", "open"),
        ("describe the appearance and the dominant color of the main "
         "finding in this scan as completely as you can, considering its "
         "overall texture and intensity",
         f"a {shape} shaped finding with a uniform {color_name} "
         "appearance",
         "Color", "open"),
        (f"is there a {probe} visible anywhere in this image, taking the "
         "whole field of view into account?",
         "yes, at least one is visible" if probe == shape
         else "no, none can be seen",
         "Presence", "closed"),
    ]


def _draw(shape: str, color: Tuple[int, int, int], count: int,
          size: int, rng: random.Random) -> np.ndarray:
    img = np.full((size, size, 3), 245, np.uint8)
    r = size // 8
    for _ in range(count):
        cx = rng.randint(r + 1, size - r - 2)
        cy = rng.randint(r + 1, size - r - 2)
        y, x = np.mgrid[0:size, 0:size]
        if shape == "circle":
            mask = (x - cx) ** 2 + (y - cy) ** 2 <= r * r
        elif shape == "square":
            mask = (np.abs(x - cx) <= r) & (np.abs(y - cy) <= r)
        else:  # cross
            mask = ((np.abs(x - cx) <= r // 3) & (np.abs(y - cy) <= r)) | (
                (np.abs(x - cx) <= r) & (np.abs(y - cy) <= r // 3))
        img[mask] = color
    return img


def normalize_image(rgb: np.ndarray) -> np.ndarray:
    """(R, R, 3) uint8 -> (3, R, R) float32 with CLIP's mean / std."""
    x = rgb.astype(np.float32) / 255.0
    x = (x - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(IMAGE_STD,
                                                             np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def synthetic_slake(n_train: int, n_test: int, *, image_size: int,
                    seed: int = 0, answer_style: str = "short",
                    n_validate: int = 0
                    ) -> Tuple[Dict[str, List[dict]], Dict[str, np.ndarray]]:
    """Entries per split in the parsed dataset schema, and CLIP-normalized
    images by name."""
    rng = random.Random(seed)
    splits: Dict[str, List[dict]] = {}
    images: Dict[str, np.ndarray] = {}
    qid = img_id = 0
    for split, n in (("train", n_train), ("validate", n_validate),
                     ("test", n_test)):
        entries = []
        for _ in range(n):
            shape = rng.choice(_SHAPES)
            color = rng.choice(sorted(_COLORS))
            count = rng.randint(1, 3)
            name = f"synthetic_{img_id:05d}.png"
            img_id += 1
            images[name] = normalize_image(
                _draw(shape, _COLORS[color], count, image_size, rng))
            if answer_style == "open":
                qa = _open_qa(shape, color, count, rng)
            else:
                probe = rng.choice(_SHAPES)
                qa = [("what shape is shown in the image?", shape, "Shape",
                       "open"),
                      (f"what color is the {shape}?", color, "Color",
                       "open"),
                      (f"is there a {probe} in the image?",
                       "yes" if probe == shape else "no", "Presence",
                       "closed")]
            for question, answer, task, atype in qa:
                entries.append({"image_name": name,
                                "question_id": str(qid),
                                "question": question.lower(),
                                "answer": answer.lower(), "task": task,
                                "question_type": atype})
                qid += 1
        splits[split] = entries
    return splits, images


def tokenizer_corpus(train: Sequence[dict], validate: Sequence[dict],
                     test: Sequence[dict]) -> List[str]:
    """The corpus a hermetic T5 tokenizer is built from (its three
    splits)."""
    corpus = [e["question"] for e in train]
    corpus += [e["answer"] for e in train]
    corpus += [e["answer"] for e in validate]
    corpus += [e["answer"] for e in test]
    corpus += [f"Answer the {t} question: " for t in sorted(
        {e["task"] for e in train})]
    corpus += ["I believe the answer is", "The most frequent answer",
               "very unlikely unlikely maybe likely very likely "
               "certainly"]
    return corpus


def generate(params: dict, seed: int
             ) -> Tuple[Dict[str, List[dict]], Dict[str, np.ndarray]]:
    """A workload's ``traffic`` parameters -> (splits, images)."""
    return synthetic_slake(
        params["n_train"], params["n_test"], image_size=params["image_size"],
        seed=seed, answer_style=params.get("answer_style", "short"),
        n_validate=params.get("n_validate", 0))
