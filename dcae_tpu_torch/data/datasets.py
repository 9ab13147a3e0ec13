"""Data pipeline: image-folder datasets with random-crop batching.

A thread-pooled PIL loader that yields NHWC float32 numpy batches, ready
for torch.from_numpy; numpy and PIL only. A copy of the JAX package's
dcae_tpu/data/datasets.py: the same seed gives the same batches. Layout:

    root/train/*.png|jpg
    root/test/*.png|jpg

Patch sampling matches the recipe: random 256^2 crops (random h-flip) for
train, center crops for test.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")


def list_images(root: str) -> List[str]:
    files = [os.path.join(root, f) for f in sorted(os.listdir(root))
             if f.lower().endswith(IMG_EXTENSIONS)]
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    return files


def load_image(path: str) -> np.ndarray:
    """HWC float32 in [0,1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
    return arr


def random_crop(img: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:  # upscale-pad small images by reflection
        img = np.pad(img, ((0, max(0, size - h)), (0, max(0, size - w)),
                           (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    out = img[top: top + size, left: left + size]
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:
        img = np.pad(img, ((0, max(0, size - h)), (0, max(0, size - w)),
                           (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return np.ascontiguousarray(img[top: top + size, left: left + size])


class ImageFolder:
    """root/{split}/ image dataset yielding crop batches."""

    def __init__(self, root: str, split: str = "train", patch_size: int = 256,
                 seed: int = 100, num_workers: int = 8):
        self.files = list_images(os.path.join(root, split))
        self.split = split
        self.patch_size = patch_size
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.files)

    def _load_crop(self, path: str, seed: int) -> np.ndarray:
        img = load_image(path)
        if self.split == "train":
            return random_crop(img, self.patch_size,
                               np.random.default_rng(seed))
        return center_crop(img, self.patch_size)

    @staticmethod
    def epoch_seed(epoch: int) -> int:
        """The seed of an epoch's order, the JAX package's. A str's hash()
        is salted per process: the processes of a data-parallel run take
        one process's (batches' order_seed)."""
        return hash(("epoch", epoch)) % (2 ** 31)

    def batches(self, batch_size: int, epoch: int = 0,
                drop_last: bool = True, order_seed: Optional[int] = None
                ) -> Iterator[np.ndarray]:
        """One epoch of NHWC float32 batches, loaded by a thread pool;
        training batches in the order of order_seed (default
        epoch_seed(epoch))."""
        order = np.arange(len(self.files))
        if self.split == "train":
            np.random.default_rng(self.epoch_seed(epoch) if order_seed is None
                                  else order_seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start: start + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            with self._lock:
                seeds = self.rng.integers(0, 2 ** 31, size=len(idx))
            futures = [self.pool.submit(self._load_crop, self.files[i],
                                        int(s))
                       for i, s in zip(idx, seeds)]
            yield np.stack([f.result() for f in futures])

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self.files) // batch_size
