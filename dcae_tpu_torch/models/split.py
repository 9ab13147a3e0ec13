"""Split-codec deployment: an encoder half and a decoder half.

One state dict (the port's = the reference's names) is partitioned by
top-level module:

    encoder machine   g_a, h_a            + the shared modules
    decoder machine   g_s                 + the shared modules
    shared            h_z_s1, h_z_s2, dt, dt_cross_attention, the slice
                      context nets, entropy_bottleneck

Each half is a DCAECodec built from its part of the state dict, so the
other half's transforms are never built and never reach its device. The
entropy tables are baked once, by the encoder half, and handed to the
decoder half: the two code under one table set. The bitstream between the
halves is integer, so they decode exactly whenever both compute the same
coding indexes (see tools/eval.py's CrossDeviceCodec for halves on
different kinds of device).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy.tables import CodecTables
from dcae_tpu_torch.models.codec import DCAECodec

COMPRESS_ONLY = ("g_a", "h_a")
DECOMPRESS_ONLY = ("g_s",)


def _top(key: str) -> str:
    return key.split(".", 1)[0]


def shared_param_keys(params: Dict) -> Tuple[str, ...]:
    """The top-level module names both halves hold (hyper synthesis,
    dictionary and its cross-attention, slice context nets, entropy
    bottleneck), in the state dict's order."""
    reserved = set(COMPRESS_ONLY) | set(DECOMPRESS_ONLY)
    out: list = []
    for k in params:
        t = _top(k)
        if t not in reserved and t not in out:
            out.append(t)
    return tuple(out)


def _keep(params: Dict, tops) -> Dict:
    keep = set(tops)
    return {k: v for k, v in params.items() if _top(k) in keep}


def compress_params(params: Dict) -> Dict:
    """The entries of the state dict an encoder machine needs."""
    return _keep(params, set(COMPRESS_ONLY) | set(shared_param_keys(params)))


def decompress_params(params: Dict) -> Dict:
    """The entries of the state dict a decoder machine needs."""
    return _keep(params,
                 set(DECOMPRESS_ONLY) | set(shared_param_keys(params)))


class ParameterSync:
    """Shipping the shared modules between the machines of a split
    deployment: a file of their tensors, written on one machine and loaded
    into the other half's state dict."""

    @staticmethod
    def extract_shared(params: Dict) -> Dict:
        return _keep(params, shared_param_keys(params))

    @staticmethod
    def inject_shared(params: Dict, shared: Dict) -> Dict:
        """params with the shared entries replaced; every shared entry must
        name one params already has, of the same shape."""
        out = dict(params)
        for k, v in shared.items():
            if k not in out or tuple(out[k].shape) != tuple(v.shape):
                raise KeyError(f"shared entry {k} does not fit this state "
                               "dict")
            out[k] = v
        return out

    @staticmethod
    def save_shared_parameters(params: Dict, path: str) -> None:
        shared = {k: torch.as_tensor(v).detach().cpu()
                  for k, v in ParameterSync.extract_shared(params).items()}
        torch.save(shared, path)

    @staticmethod
    def load_shared_parameters(params: Dict, path: str) -> Dict:
        shared = torch.load(path, map_location="cpu", weights_only=True)
        return ParameterSync.inject_shared(params, shared)


class SplitCompressor:
    """Encoder half: g_a / h_a and the shared modules on `device`, and the
    tables, baked here once (update(force=True)) unless given."""

    def __init__(self, cfg: DCAEConfig, params: Dict,
                 tables: Optional[CodecTables] = None, device=None,
                 dtype: Optional[torch.dtype] = None):
        self._codec = DCAECodec(cfg, params=compress_params(params),
                                tables=tables, device=device, dtype=dtype)
        if tables is None:
            self._codec.update(force=True)

    @property
    def codec(self) -> DCAECodec:
        return self._codec

    @property
    def tables(self) -> CodecTables:
        return self._codec.tables

    def compress(self, x, **kw) -> dict:
        return self._codec.compress(x, **kw)

    def close(self) -> None:
        self._codec.close()


class SplitDecompressor:
    """Decoder half: g_s and the shared modules on `device`; the tables
    come from the encoder half."""

    def __init__(self, cfg: DCAEConfig, params: Dict, tables: CodecTables,
                 device=None, dtype: Optional[torch.dtype] = None):
        self._codec = DCAECodec(cfg, params=decompress_params(params),
                                tables=tables, device=device, dtype=dtype)

    @property
    def codec(self) -> DCAECodec:
        return self._codec

    def decompress(self, strings, shape, **kw) -> dict:
        return self._codec.decompress(strings, shape, **kw)

    def close(self) -> None:
        self._codec.close()


def make_split_pair(cfg: DCAEConfig, params: Dict, enc_device=None,
                    dec_device=None, dtype: Optional[torch.dtype] = None
                    ) -> Tuple[SplitCompressor, SplitDecompressor]:
    """An encoder half and a decoder half of `params`, the decoder on the
    encoder's tables. Devices default to CUDA (each raises without a card
    unless given "cpu")."""
    enc = SplitCompressor(cfg, params, device=enc_device, dtype=dtype)
    dec = SplitDecompressor(cfg, params, enc.tables, device=dec_device,
                            dtype=dtype)
    return enc, dec
