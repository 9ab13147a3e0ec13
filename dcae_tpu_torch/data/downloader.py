"""OpenImages training-set downloader, a copy of the JAX package's
data/downloader.py: sample image ids from the OpenImages CSV manifest and
fetch the originals from the public S3 bucket into a train/ directory.
Needs boto3 (an optional dependency, imported only when a download
starts; the rest of the port never needs it).
"""

from __future__ import annotations

import concurrent.futures
import csv
import os
import random
from typing import List, Optional

OPENIMAGES_BUCKET = "open-images-dataset"


def sample_image_ids(csv_path: str, n: int, seed: int = 100,
                     split: str = "train") -> List[str]:
    """Sample n image ids from an OpenImages image-ids CSV manifest."""
    ids = []
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        col = header.index("ImageID") if "ImageID" in header else 0
        for row in reader:
            if row:
                ids.append(row[col])
    rng = random.Random(seed)
    rng.shuffle(ids)
    del split
    return ids[:n]


def download_images(image_ids: List[str], out_dir: str,
                    split: str = "train", num_workers: int = 16,
                    progress: bool = True) -> List[str]:
    """Fetch originals from the OpenImages S3 bucket (anonymous access)."""
    try:
        import boto3
        import botocore
    except ImportError as e:
        raise RuntimeError(
            "boto3 is required for downloading OpenImages; install it or "
            "provide a local dataset directory instead") from e

    os.makedirs(out_dir, exist_ok=True)
    s3 = boto3.resource(
        "s3",
        config=botocore.config.Config(
            signature_version=botocore.UNSIGNED))
    bucket = s3.Bucket(OPENIMAGES_BUCKET)

    def fetch(image_id: str) -> Optional[str]:
        path = os.path.join(out_dir, f"{image_id}.jpg")
        if os.path.exists(path):
            return path
        try:
            bucket.download_file(f"{split}/{image_id}.jpg", path)
            return path
        except Exception as e:  # noqa: BLE001 — skip failures, keep going
            print(f"failed {image_id}: {e}")
            return None

    done = []
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        for i, path in enumerate(pool.map(fetch, image_ids)):
            if path:
                done.append(path)
            if progress and i % 100 == 0:
                print(f"{i}/{len(image_ids)} downloaded", end="\r")
    if progress:
        print(f"\n{len(done)}/{len(image_ids)} images in {out_dir}")
    return done


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="OpenImages downloader")
    p.add_argument("--csv", required=True, help="image-ids CSV manifest")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("-n", type=int, default=300_000)
    p.add_argument("--split", default="train")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--workers", type=int, default=16)
    a = p.parse_args(argv)
    ids = sample_image_ids(a.csv, a.n, a.seed, a.split)
    download_images(ids, a.out, a.split, a.workers)


if __name__ == "__main__":
    main()
