""".bin bitstream containers.

The classic codec's, byte for byte the reference's layout:

    >H height | >H width | >I len(y_string) | y_string
    | >I len(z_string) | z_string

(h, w are the ORIGINAL unpadded image dims; the decoder recomputes the
pad-to-128 geometry and z_shape = padded / z_downsample.)

The interleaved (device-coding) profile's, magic-tagged and byte for byte
the JAX package's (one image a file):

    b"DTI1" | >H h | >H w | >H lanes | >B n_slices | >I field |
    per slice: >I len(stream) | stream | lanes * 4 bytes of LE uint32 states
               | >H n_patches | n_patches LE uint32 pos
               | n_patches LE int32 val
    | >I len(z_string) | z_string

    b"DTI2", the CHAINED layout: ONE K-lane state set spans all slices, so
    the lanes * 4 state bytes are written ONCE, right after the field, and
    not per slice; everything else as DTI1.

field = bucket | unroll << 24 | paired << 31: the word-buffer width
compress_device recorded (0 = none, a host-encoded stream; low 24 bits),
the decode loop's unroll (bits 24-30; 0 = unspecified) and the paired
slot-table flag. They shaped the JAX package's decode program; this
package's decoder validates and otherwise ignores them. Patches are the
(rare) Gaussian-tail symbols the stream carries clamped into their CDF
row's in-range buckets; the decoder scatters the exact values back right
after entropy decode.

The latent hand-off's ("DLT1"), byte for byte the JAX package's: the raw
analysis latent y instead of a coded stream.

    b"DLT1" | >H h | >H w | >B dtype code | >f scale | >B ndim
    | ndim x >I dim | raw values (little-endian)

dtype code 0 float32, 1 float16, 2 bfloat16, 3 int8; scale is the int8
dequantization multiplier (max|y| / 127) and 1.0 for the floats.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch


def calculate_padding(h: int, w: int, p: int = 128):
    """(padded_size, (left, right, top, bottom)): centered pad to a
    multiple of p."""
    new_h = (h + p - 1) // p * p
    new_w = (w + p - 1) // p * p
    left = (new_w - w) // 2
    right = new_w - w - left
    top = (new_h - h) // 2
    bottom = new_h - h - top
    return (new_h, new_w), (left, right, top, bottom)


def pack_bin(strings: Sequence[Sequence[bytes]],
             size: Tuple[int, int]) -> bytes:
    """strings = [[y_string], [z_string]]; size = (h, w) unpadded."""
    y_string = strings[0][0]
    z_string = strings[1][0]
    out = struct.pack(">H", size[0])
    out += struct.pack(">H", size[1])
    out += struct.pack(">I", len(y_string))
    out += y_string
    out += struct.pack(">I", len(z_string))
    out += z_string
    return out


def unpack_bin(data: bytes, p: int = 128, z_downsample: int = 64):
    """-> (strings, z_shape, padding, (h, w))."""
    h, w = struct.unpack(">HH", data[:4])
    off = 4
    (ylen,) = struct.unpack(">I", data[off: off + 4])
    off += 4
    y_string = data[off: off + ylen]
    off += ylen
    (zlen,) = struct.unpack(">I", data[off: off + 4])
    off += 4
    z_string = data[off: off + zlen]
    padded, padding = calculate_padding(h, w, p)
    z_shape = (padded[0] // z_downsample, padded[1] // z_downsample)
    return [[y_string], [z_string]], z_shape, padding, (h, w)


def save_bin(path: str, strings, size: Tuple[int, int]) -> None:
    with open(path, "wb") as f:
        f.write(pack_bin(strings, size))


def read_bin(path: str, p: int = 128, z_downsample: int = 64):
    with open(path, "rb") as f:
        return unpack_bin(f.read(), p, z_downsample)


# ---- the interleaved (device-coding) profile ----------------------------

_MAGIC_V2 = b"DTI1"
_MAGIC_V2_CHAIN = b"DTI2"
# the unroll values a reader accepts: 0 (unspecified) or a power of two
_UNROLLS = (0, 1, 2, 4, 8, 16, 32, 64)


def pack_bin_interleaved(enc: dict, size: Tuple[int, int]) -> bytes:
    """enc: compress_interleaved / compress_device output (batch 1); size =
    (h, w) unpadded. Chained dicts (states (K,), enc["chained"]) pack as
    DTI2, per-slice state dicts as DTI1. Refuses what unpack_bin_interleaved
    would refuse: an unroll that is not 0 or a power of two <= 64."""
    states = np.asarray(enc["states"], dtype="<u4")
    lanes = int(enc["lanes"])
    streams = enc["istreams"]
    chained = bool(enc.get("chained", states.ndim == 1))
    patches = enc.get("patches") or [
        (np.empty(0, np.int32),) * 2 for _ in streams]
    out = _MAGIC_V2_CHAIN if chained else _MAGIC_V2
    out += struct.pack(">HHHB", size[0], size[1], lanes, len(streams))
    bucket = int(enc.get("bucket") or 0)
    unroll = int(enc.get("unroll") or 0)
    paired = 1 if enc.get("paired") else 0
    if not 0 <= bucket < 1 << 24:
        raise ValueError(f"bucket out of field range: {bucket}")
    if unroll not in _UNROLLS:
        raise ValueError(f"unroll {unroll}: the DTI field carries 0 or a "
                         "power of two <= 64")
    out += struct.pack(">I", bucket | (unroll << 24) | (paired << 31))
    if chained:
        out += states.reshape(-1).tobytes()  # once, for the whole chain
    for s, stream in enumerate(streams):
        out += struct.pack(">I", len(stream))
        out += stream
        if not chained:
            out += states[s].tobytes()
        pos, val = patches[s]
        out += struct.pack(">H", len(pos))
        out += np.asarray(pos, "<u4").tobytes()
        out += np.asarray(val, "<i4").tobytes()
    z = enc["z_strings"][0]
    out += struct.pack(">I", len(z))
    out += z
    return out


def unpack_bin_interleaved(data: bytes, p: int = 128,
                           z_downsample: int = 64):
    """-> (enc dict for decompress_interleaved, padding, (h, w))."""
    if data[:4] not in (_MAGIC_V2, _MAGIC_V2_CHAIN):
        raise ValueError("not a DTI1/DTI2 interleaved container")
    chained = data[:4] == _MAGIC_V2_CHAIN
    h, w, lanes, n_slices = struct.unpack(">HHHB", data[4:11])
    (field,) = struct.unpack(">I", data[11:15])
    bucket = field & 0xFFFFFF
    unroll = (field >> 24) & 0x7F
    paired = bool(field >> 31)
    if unroll not in _UNROLLS:
        raise ValueError(
            f"DTI unroll field {unroll} was never produced by any writer "
            "(0 or a power of two <= 64); the blob is corrupt or from an "
            "incompatible format revision")
    off = 15
    chain_states = None
    if chained:
        chain_states = np.frombuffer(data[off: off + 4 * lanes], "<u4")
        off += 4 * lanes
    streams: List[bytes] = []
    states = []
    patches = []
    for _ in range(n_slices):
        (slen,) = struct.unpack(">I", data[off: off + 4])
        off += 4
        streams.append(data[off: off + slen])
        off += slen
        if not chained:
            states.append(np.frombuffer(data[off: off + 4 * lanes], "<u4"))
            off += 4 * lanes
        (n_patch,) = struct.unpack(">H", data[off: off + 2])
        off += 2
        pos = np.frombuffer(data[off: off + 4 * n_patch], "<u4"
                            ).astype(np.int32)
        off += 4 * n_patch
        val = np.frombuffer(data[off: off + 4 * n_patch], "<i4"
                            ).astype(np.int32)
        off += 4 * n_patch
        patches.append((pos, val))
    (zlen,) = struct.unpack(">I", data[off: off + 4])
    off += 4
    z_string = data[off: off + zlen]
    padded, padding = calculate_padding(h, w, p)
    z_shape = (padded[0] // z_downsample, padded[1] // z_downsample)
    enc = {"istreams": streams,
           "states": (chain_states if chained else np.stack(states)),
           "patches": patches, "z_strings": [z_string], "shape": z_shape,
           "lanes": lanes, "bucket": bucket, "unroll": unroll,
           "paired": paired, "chained": chained}
    return enc, padding, (h, w)


def is_interleaved_bin(data: bytes) -> bool:
    return data[:4] in (_MAGIC_V2, _MAGIC_V2_CHAIN)


# ---- the latent hand-off -------------------------------------------------

_MAGIC_LATENT = b"DLT1"
_LATENT_DTYPES = {0: "float32", 1: "float16", 2: "bfloat16", 3: "int8"}
_LATENT_CODES = {v: k for k, v in _LATENT_DTYPES.items()}


def pack_latent(y, size: Tuple[int, int], dtype: str = "float32") -> bytes:
    """y: (B, yh, yw, M) analysis latent (numpy or tensor); size = (h, w)
    unpadded; dtype: the shipped representation. int8 is scaled by max|y|
    and rounded to nearest; bfloat16 rounds to nearest even (torch's cast,
    bit-identical to the JAX package's ml_dtypes cast)."""
    if dtype not in _LATENT_CODES:
        raise ValueError(f"unsupported latent dtype {dtype!r}")
    if torch.is_tensor(y):
        y = y.detach().cpu().numpy()
    y = np.asarray(y, np.float32)
    scale = 1.0
    if dtype == "int8":
        amax = float(np.max(np.abs(y))) or 1.0
        scale = amax / 127.0
        payload = np.clip(np.rint(y / scale), -128, 127).astype(np.int8)
    elif dtype == "bfloat16":
        payload = torch.from_numpy(np.ascontiguousarray(y)).to(
            torch.bfloat16).view(torch.int16).numpy()
    else:
        payload = y.astype(dtype)
    out = _MAGIC_LATENT
    out += struct.pack(">HHBf", size[0], size[1], _LATENT_CODES[dtype],
                       scale)
    out += struct.pack(">B", y.ndim)
    for d in y.shape:
        out += struct.pack(">I", d)
    out += payload.astype(payload.dtype.newbyteorder("<")).tobytes()
    return out


def unpack_latent(data: bytes, p: int = 128):
    """-> (y float32 numpy (B, yh, yw, M), padding, (h, w))."""
    if data[:4] != _MAGIC_LATENT:
        raise ValueError("not a DLT1 latent container")
    h, w, code, scale = struct.unpack(">HHBf", data[4:13])
    (ndim,) = struct.unpack(">B", data[13:14])
    off = 14
    shape = []
    for _ in range(ndim):
        (d,) = struct.unpack(">I", data[off: off + 4])
        shape.append(d)
        off += 4
    dtype = _LATENT_DTYPES[code]
    raw = np.frombuffer(data[off:], dtype="<i2" if dtype == "bfloat16"
                        else np.dtype(dtype).newbyteorder("<"))
    raw = raw.reshape(shape)
    if dtype == "bfloat16":
        y = torch.from_numpy(raw.astype(np.int16)).view(
            torch.bfloat16).to(torch.float32).numpy()
    else:
        y = raw.astype(np.float32)
    if dtype == "int8":
        y = y * scale
    _, padding = calculate_padding(h, w, p)
    return y, padding, (h, w)


def is_latent_bin(data: bytes) -> bool:
    return data[:4] == _MAGIC_LATENT
