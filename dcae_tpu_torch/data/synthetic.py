"""The two synthetic corpora of the JAX package, for runs that have no
image set: gradients, coarse block texture, soft rectangles and mild
noise (natural-image-like spectra, not white noise).

  * synth_image / make_dataset: the training validator's corpus, 256^2
    PNGs in root/train and root/test (tools/validate_training.py);
  * synthetic_kodak: the benchmark's corpus of 768x512 uint8 images
    (bench.py).

Copies: the same seed gives the same bytes as the originals.
"""

from __future__ import annotations

import os

import numpy as np


def synth_image(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """One (size, size, 3) f32 image in [0, 1]."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w] / size
    img = np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                        + rng.uniform(0, 1))),
        0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy
                                        + rng.uniform(0, 1))),
        0.5 * (xx + yy),
    ], axis=-1)
    blocks = rng.uniform(0, 1, (8, 8, 3))
    img = 0.6 * img + 0.4 * np.kron(blocks, np.ones((size // 8, size // 8,
                                                     1)))
    for _ in range(6):
        t, l = rng.integers(0, h - 32, 2)
        bh, bw = rng.integers(16, 96, 2)
        img[t:t + bh, l:l + bw] = (0.7 * img[t:t + bh, l:l + bw]
                                   + 0.3 * rng.uniform(0, 1, 3))
    img += rng.normal(0, 0.01, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def make_dataset(root: str, n_train: int = 200, n_test: int = 16,
                 size: int = 256, seed: int = 0) -> None:
    """root/train/0000.png ... and root/test/0000.png ...: n_train and
    n_test images of synth_image, in that order from one generator."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = (synth_image(rng, size) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:04d}.png"))


def synthetic_kodak(n: int, h: int = 512, w: int = 768,
                    seed: int = 100) -> np.ndarray:
    """n structured images as uint8 (n, h, w, 3), as real Kodak PNGs are
    (the codec's uint8 ingress uploads a byte a pixel)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * xx
                                            + rng.uniform(0, 1))),
            0.5 + 0.5 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy
                                            + rng.uniform(0, 1))),
            0.5 * (xx + yy),
        ], axis=-1)
        blocks = rng.uniform(0, 1, (8, 8, 3))
        img = 0.6 * img + 0.4 * np.kron(blocks, np.ones((h // 8, w // 8, 1)))
        for _ in range(6):
            t = rng.integers(0, h - 32)
            l = rng.integers(0, w - 32)
            bh, bw = rng.integers(16, 160, 2)
            img[t:t + bh, l:l + bw] = (0.7 * img[t:t + bh, l:l + bw]
                                       + 0.3 * rng.uniform(0, 1, 3))
        imgs[i] = img + rng.normal(0, 0.01, img.shape)
    return (np.clip(imgs, 0, 1) * 255).round().astype(np.uint8)
