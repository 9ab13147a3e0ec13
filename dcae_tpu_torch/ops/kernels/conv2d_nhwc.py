"""NHWC stride-1 convolution (1x1, 3x3 or 5x5, padding k // 2) with its
bias and the activation after it, in f32, at inference.

It replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
`conv2d_nhwc` launches the CUDA kernel (csrc/conv2d_nhwc.cu: an implicit
GEMM in 3xTF32 on Hopper's warpgroup products; 5x5 in a kernel of its own
name) for CUDA tensors and runs `conv2d_nhwc_ref`, the plain statement the
layers ran before it (F.conv2d on the channels-last view, then the
activation), for CPU tensors.

`routes` is where the model sends a convolution here: f32, stride 1,
groups 1, kernel 1x1 or 3x3 (5x5 too where the layer asks: ELIC's
contexts) with padding k // 2, and no gradient wanted. It looks at no
device, so the CPU runs the same call graph. A convolution under
autograd (training) keeps cuDNN: the kernel has no backward.

`taps="odd"` (5x5 only) is ELIC's checkerboard-masked convolution: only
the 12 taps whose row + column is odd count, as if the others' weights
were zero. The kernel runs those 12 alone; the plain statement convolves
with the weight masked so (`masked_weight`).

The weight is packed once for the kernel, (C_out, taps, C_in rounded up
to 32) with zeros past C_in, and split there into its tf32 hi and the
rest lo (the kernel splits only x); both halves (or the masked weight) are
kept until the weight changes (its version counter or storage): see
`packed_weight`.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.weak import WeakTensorKeyDictionary

from dcae_tpu_torch.ops.kernels import _build, note_launch
from dcae_tpu_torch.ops.kernels._grad import wants_grad

# the activation after a convolution, by name; the kernel's codes
ACTS = {"none": lambda t: t, "gelu": F.gelu, "relu": F.relu}
_ACT_CODE = {"none": 0, "gelu": 1, "relu": 2}
# the taps a convolution sums over, by name; the kernel's codes
TAPS = {"all": 0, "odd": 1}

K_SLICE = 32      # K columns a stage of the kernel: the packed C_in multiple

# The kernel's tile shapes (BM, BN), by the index csrc/conv2d_nhwc.cu gives
# them: BM is 64 rows a consumer warpgroup. TILE_BLOCKS: the blocks of a
# tile an SM holds at once (one consumer warpgroup: two).
# TILE_COST: the device time of a tile's output element relative to the
# others, K for K, with its SMs shared as TILE_BLOCKS says (fitted to every
# tile's time at the three codec cells' shapes on an H100: its picks take
# at most 0.12 ms a pass more than the fastest tile at each would).
TILES = ((192, 112), (192, 64), (64, 64), (64, 32))
TILE_BLOCKS = (1, 1, 2, 2)
TILE_COST = (1.0, 1.2, 1.35, 1.5)


def routes(conv: nn.Conv2d, x: torch.Tensor, sizes=(1, 3)) -> bool:
    """Whether `conv` on x goes through conv2d_nhwc: f32 operands, stride
    1, groups 1, no dilation, a square kernel of a size in `sizes` with
    zero padding k // 2, and no gradient wanted (grad mode off, or no
    operand requires grad). `sizes`: 1x1 and 3x3 for the port's plain
    layers (ops/layers.py Conv); ELIC's entropy-side layers add 5x5
    (ops/elic_blocks.py ContextConv)."""
    k = conv.kernel_size
    return (x.dtype == torch.float32 and conv.weight.dtype == torch.float32
            and k[0] == k[1] and k[0] in sizes and conv.stride == (1, 1)
            and conv.padding == (k[0] // 2, k[0] // 2)
            and conv.dilation == (1, 1) and conv.groups == 1
            and conv.padding_mode == "zeros"
            and not wants_grad((x, conv.weight, conv.bias)))


def tap_mask(k: int, taps: str) -> torch.Tensor:
    """(k, k) f32: 1 at the taps `taps` names, 0 elsewhere ("odd": row +
    column odd, the checkerboard mask of ELIC's spatial context)."""
    if taps == "all":
        return torch.ones(k, k)
    r = torch.arange(k)
    return ((r[:, None] + r[None, :]) % 2 == 1).to(torch.float32)


def conv2d_nhwc_ref(x, weight, bias, *, act: str = "none",
                    taps: str = "all") -> torch.Tensor:
    """Plain statement: F.conv2d on the channels-last view of x (B, H, W,
    C), padding k // 2, with the weight masked to `taps`, the result viewed
    back as NHWC, then `act`."""
    if taps != "all":
        weight = masked_weight(weight, taps)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                 padding=weight.shape[-1] // 2)
    return ACTS[act](y.permute(0, 2, 3, 1))


@functools.cache
def _entry():
    lib = _build.load_kernel("conv2d_nhwc")
    return _build.bind(lib, "dcae_conv2d_nhwc", 5, 12)



@functools.lru_cache(maxsize=1024)
def pick_tile(M: int, N: int, sms: int) -> int:
    """The tile shape of a call of M output pixels and N channels on a card
    of `sms` SMs: the least estimated time, the rounds of tiles an SM runs
    (ceil(tiles / (sms x TILE_BLOCKS))), each TILE_BLOCKS tiles' work at
    their relative cost. Each output's sum runs in the same order whatever
    the tile, so the choice changes no result."""
    def cost(t):
        bm, bn = TILES[t]
        tiles = math.ceil(M / bm) * math.ceil(N / bn)
        rounds = math.ceil(tiles / (sms * TILE_BLOCKS[t]))
        return rounds * TILE_BLOCKS[t] * bm * bn * TILE_COST[t], t
    return min(cost(t) for t in range(len(TILES)))[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_kept = WeakTensorKeyDictionary()


def _kept_copy(weight: torch.Tensor, what: tuple, make) -> torch.Tensor:
    """make(weight), kept beside the weight under `what` until the weight
    changes: an in-place update (its version counter) or a new storage."""
    key = (weight._version, weight.data_ptr(), weight.device)
    copies = _kept.get(weight)
    if copies is None or copies[0] != key:
        copies = (key, {})
        _kept[weight] = copies
    if what not in copies[1]:
        copies[1][what] = make(weight)
    return copies[1][what]


def split_tf32(t: torch.Tensor) -> tuple:
    """(hi, lo) of an f32 tensor, as the kernel's split_tf32: hi is t with
    its low 13 mantissa bits cleared (a tf32 value), lo = t - hi, exact."""
    hi = (t.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, t - hi


def pack_weight(weight: torch.Tensor, taps: str = "all") -> tuple:
    """(C_out, C_in, k, k) -> (hi, lo), each (C_out, taps, C_in rounded up
    to K_SLICE), zeros past C_in: the kernel's K order, tap by tap, over the
    taps `taps` names (row-major), split by split_tf32 (hi + lo is the
    weight exactly)."""
    c_out, c_in, k, _ = weight.shape
    w = weight.detach().permute(0, 2, 3, 1).reshape(c_out, k * k, c_in)
    if taps != "all":
        w = w[:, tap_mask(k, taps).reshape(-1).nonzero().reshape(-1)
              .to(w.device)]
    w = F.pad(w, (0, -(-c_in // K_SLICE) * K_SLICE - c_in)).contiguous()
    return split_tf32(w)


def packed_weight(weight: torch.Tensor, taps: str = "all") -> tuple:
    """pack_weight(weight, taps), both halves kept beside the weight until
    it changes."""
    return _kept_copy(weight, ("packed", taps),
                      lambda w: pack_weight(w, taps))


def masked_weight(weight: torch.Tensor, taps: str) -> torch.Tensor:
    """The weight with its taps outside `taps` zeroed, kept beside the
    weight until it changes."""
    k = weight.shape[-1]
    return _kept_copy(weight, ("masked", taps), lambda w: w.detach()
                      * tap_mask(k, taps).to(w.device, w.dtype))


def launch(x, weight, bias, *, act: str, taps: str = "all") -> torch.Tensor:
    """Launch the kernel of csrc/conv2d_nhwc.cu on CUDA tensors. Raises on
    any other device and on what the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_nhwc: no kernel for {x.device}")
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError("conv2d_nhwc: f32 operands only")
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("conv2d_nhwc: x (B, H, W, C), weight (N, C, k, k)")
    B, H, W, C = x.shape
    N, c_w, k, k2 = weight.shape
    if c_w != C or k != k2 or k not in (1, 3, 5):
        raise ValueError(f"conv2d_nhwc: weight {tuple(weight.shape)} for "
                         f"{C} channels (1x1, 3x3 or 5x5 only)")
    if taps not in TAPS or (taps != "all" and k != 5):
        raise ValueError(f"conv2d_nhwc: taps {taps!r} at k = {k} ('odd' "
                         "is 5x5 only)")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"conv2d_nhwc: bias {tuple(bias.shape)}, want ({N},)")
    if act not in _ACT_CODE:
        raise ValueError(f"conv2d_nhwc: activation {act!r}, one of "
                         f"{sorted(_ACT_CODE)}")
    for t in (weight, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv2d_nhwc: operands on {t.device} and "
                             f"{x.device}")
    M = B * H * W
    if M == 0 or N == 0:
        raise ValueError("conv2d_nhwc: empty input or output")
    if M * max(C, N) >= 2 ** 31:
        raise ValueError("conv2d_nhwc: more than 2**31 elements")
    # pixels `ldx` floats apart with unit channel stride: a channels-last
    # view (a slice of channels included); anything else is copied
    s = x.stride()
    if s[3] == 1 and s[1] == W * s[2] and s[0] == H * s[1] and s[2] >= C:
        ldx = s[2]
    else:
        x, ldx = x.contiguous(), C
    whi, wlo = packed_weight(weight, taps)
    if bias is not None:
        bias = bias.contiguous()
    vec = int(C % 4 == 0 and ldx % 4 == 0 and x.data_ptr() % 16 == 0)
    tile = pick_tile(M, N, _sms(x.device.index or 0))
    out = torch.empty((B, H, W, N), dtype=torch.float32, device=x.device)
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                B, H, W, C, ldx, N, k, TAPS[taps], whi.shape[-1],
                _ACT_CODE[act], tile, vec, stream)
    _build.check(rc, "conv2d_nhwc")
    conv2d_nhwc.tile_launches[tile] += 1
    return out


def conv2d_nhwc(x, weight, bias=None, *, act: str = "none",
                taps: str = "all") -> torch.Tensor:
    """x: (B, H, W, C) f32, weight (N, C, k, k) with k 1, 3 or 5, bias (N)
    or None -> act(conv(x) + bias): (B, H, W, N), stride 1, padding k // 2,
    over the taps `taps` names ("odd": the checkerboard mask, 5x5 only).
    CPU tensors run conv2d_nhwc_ref; CUDA tensors launch the kernel or
    raise, also where a gradient is wanted (the kernel has none: `routes`
    sends such calls to cuDNN). `launches` counts kernel launches, and
    `tile_launches` the launches of each tile of TILES, by index."""
    if x.device.type == "cpu":
        return conv2d_nhwc_ref(x, weight, bias, act=act, taps=taps)
    if wants_grad((x, weight, bias)):
        raise ValueError("conv2d_nhwc: the kernel has no gradient; a call "
                         "under autograd runs cuDNN (see routes)")
    out = launch(x, weight, bias, act=act, taps=taps)
    conv2d_nhwc.launches += 1
    B, H, W, C = x.shape
    N, _, k, _ = weight.shape
    n_taps = k * k if taps == "all" else k * k // 2   # odd: r + s odd
    note_launch("conv2d_nhwc", 2 * B * H * W * N * n_taps * C, x, out,
                *(t for t in (weight, bias) if t is not None))
    return out


conv2d_nhwc.launches = 0
conv2d_nhwc.tile_launches = [0] * len(TILES)
