""".bin bitstream container of the classic codec, byte for byte the
reference's layout:

    >H height | >H width | >I len(y_string) | y_string
    | >I len(z_string) | z_string

(h, w are the ORIGINAL unpadded image dims; the decoder recomputes the
pad-to-128 geometry and z_shape = padded / z_downsample.)
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple


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
