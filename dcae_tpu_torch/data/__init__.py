"""Data tooling: image-folder datasets (numpy + PIL only)."""

from dcae_tpu_torch.data.datasets import (ImageFolder, center_crop,
                                          list_images, load_image,
                                          random_crop)

__all__ = ["ImageFolder", "list_images", "load_image", "random_crop",
           "center_crop"]
