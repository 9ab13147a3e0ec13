"""Model configuration of the DCAE codec (the PyTorch port's own copy).

Same fields and defaults as the JAX package's configuration, minus its
TPU-only switches: the port launches its hand-written kernels whenever the
tensors lie on a CUDA device, so there is nothing to turn on. One field
chooses between two kernel paths: `fused_attention_block`, the explicit
counterpart of the JAX package's DCAE_PALLAS_V4 environment variable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DCAEConfig:
    """Hyperparameters of the DCAE codec.

    Defaults reproduce the reference model: N=192, M=320, 5 channel-AR
    slices, feature dims (96,144,256), (1,2,12) transformer blocks per stage,
    window 8 (main) / 4 (hyper), a 128x640 dictionary with 20 heads.
    """

    N: int = 192                      # hyper transform width
    M: int = 320                      # latent (y) channels
    num_slices: int = 5               # channel-AR slices
    max_support_slices: int = 5
    feature_dim: Tuple[int, int, int] = (96, 144, 256)
    block_num: Tuple[int, int, int] = (1, 2, 12)
    head_dim: Tuple[int, int, int, int, int, int] = (8, 16, 32, 32, 16, 8)
    window_size: int = 8
    hyper_window_size: int = 4
    hyper_head_dim: int = 32
    in_channels: int = 3
    out_channels: int = 3

    # dictionary cross-attention entropy model
    dict_num: int = 128
    dict_head_num: int = 20
    dict_head_dim: int = 32
    mlp_rate: int = 4
    qkv_bias: bool = True

    # per-slice context-transform hidden widths (cc_mean/cc_scale/lrp nets)
    cc_hidden: Tuple[int, int] = (224, 128)

    # entropy bottleneck (factorized prior over z)
    eb_channels: int = 192
    eb_filters: Tuple[int, ...] = (3, 3, 3, 3)
    eb_init_scale: float = 10.0
    eb_tail_mass: float = 1e-9

    # Gaussian conditional scale table
    scales_min: float = 0.11
    scales_max: float = 256.0
    scales_levels: int = 64
    gc_tail_mass: float = 1e-9

    # drift-robust training noise (0 disables; training is not ported yet)
    drift_noise: float = 0.0

    # compute dtype of the one-sided transforms g_a/h_a/g_s ("float32" or
    # "bfloat16"); the entropy-side nets always run float32.
    compute_dtype: str = "float32"

    # window-8 Swin blocks: LN1 + window attention + res-scale residual as
    # one wmsa_block kernel (True, the wmsa_v4 path), or LN1 on its own, the
    # wmsa_attention kernel and the residual outside it (False, the
    # wmsa_v3 path). Parameters are the same either way.
    fused_attention_block: bool = True

    @property
    def dict_dim(self) -> int:
        return self.dict_head_dim * self.dict_head_num

    @property
    def slice_dim(self) -> int:
        return self.M // self.num_slices

    def query_dim(self, slice_index: int) -> int:
        """Channels of the slice-i query: latent_scales + latent_means +
        previously decoded slices."""
        i = min(slice_index, self.max_support_slices)
        return 2 * self.M + self.slice_dim * i

    def support_dim(self, slice_index: int) -> int:
        """query + dictionary info (M channels)."""
        return self.query_dim(slice_index) + self.M

    @property
    def y_downsample(self) -> int:
        """Total stride of g_a (x -> y)."""
        return 2 ** (len(self.feature_dim) + 1)

    @property
    def hyper_ratio(self) -> int:
        """Spatial ratio between y and z (h_a: two stride-2 layers)."""
        return 4

    @property
    def z_downsample(self) -> int:
        return self.y_downsample * self.hyper_ratio

    @property
    def pad_multiple(self) -> int:
        # windows at y-resolution need divisibility by window_size
        return self.y_downsample * self.window_size

    @classmethod
    def tiny(cls, **overrides) -> "DCAEConfig":
        """A small config for unit tests (same topology, tiny dims)."""
        base = dict(
            N=16,
            M=20,
            num_slices=5,
            feature_dim=(8, 12, 16),
            block_num=(1, 1, 2),
            head_dim=(4, 4, 4, 4, 4, 4),
            window_size=4,
            hyper_window_size=2,
            hyper_head_dim=8,
            dict_num=8,
            dict_head_num=2,
            dict_head_dim=8,
            cc_hidden=(16, 12),
            eb_channels=16,
            eb_init_scale=10.0,
        )
        base.update(overrides)
        return cls(**base)
