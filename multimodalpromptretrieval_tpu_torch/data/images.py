"""Preprocessed-image cache (the analogue of the reference's
``images_{split}.pkl``).

Counterpart of ``multimodalpromptretrieval_tpu/data/images.py``, with the
same file: ``images_{split}_{size}.npz``, (3, size, size) float32 arrays
keyed by image name, so a cache written by either package loads in the
other. Missing images are decoded with PIL and preprocessed on the device
(``ops/image.py``); PIL is imported only then, so a complete cache needs
none.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodalpromptretrieval_tpu_torch.ops.image import (
    preprocess_pil_images,
)
from multimodalpromptretrieval_tpu_torch.utils import savez_atomic


def cache_path(cache_dir: str, split: str, size: int) -> str:
    """The resolution is part of the name: a cache of another grid size is
    never served."""
    return os.path.join(cache_dir, f"images_{split}_{size}.npz")


class ImageCache:
    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = arrays

    def __getitem__(self, name: str) -> np.ndarray:
        return self.arrays[name]

    def __contains__(self, name: str) -> bool:
        return name in self.arrays

    def __len__(self) -> int:
        return len(self.arrays)

    def update(self, other: "ImageCache") -> None:
        self.arrays.update(other.arrays)

    def batch(self, names: Sequence[str]) -> np.ndarray:
        return np.stack([self.arrays[n] for n in names])

    @staticmethod
    def build(dataroot: str, entries: List[dict], split: str,
              size: int = 224, subdir: str = "imgs",
              cache_dir: Optional[str] = None,
              device: Optional[torch.device] = None) -> "ImageCache":
        """Load-or-build ``images_{split}_{size}.npz`` for the unique images
        of ``entries``. Names missing from the file are decoded, preprocessed
        on ``device`` and added to it (a cache written by a filtered run may
        not cover this run's entries)."""
        path = cache_path(cache_dir or dataroot, split, size)
        arrays: Dict[str, np.ndarray] = {}
        if os.path.exists(path):
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            if arrays and next(iter(arrays.values())).shape[-1] != size:
                arrays = {}  # another wire format: rebuild everything
        names = list(dict.fromkeys(e["image_name"] for e in entries))
        missing = [n for n in names if n not in arrays]
        if missing:
            from concurrent.futures import ThreadPoolExecutor

            from PIL import Image

            def load(n):
                with Image.open(os.path.join(dataroot, subdir, n)) as im:
                    if im.mode != "RGB":
                        im = im.convert("RGB")
                    return im.copy()

            # PIL's decode releases the GIL, so threads scale
            with ThreadPoolExecutor(max_workers=8) as pool:
                pil = list(pool.map(load, missing))
            arrays.update(zip(missing, preprocess_pil_images(
                pil, size=size, device=device)))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            savez_atomic(path, **arrays)
        return ImageCache({n: arrays[n] for n in names})
