"""Host codec driver: real bitstream compress() / decompress().

  compress    three encoder modes, one stream format:
              staged  g_a + h_a once, then the encoder REPLAYS the
                      decoder's own functions (decode_start / decode_step)
                      step by step and rounds each step's symbols on the
                      host against the decoder's mu: the mu/sigma/indexes
                      it codes under are the ones the decoder will compute.
                      One device-to-host round trip per step.
              split   encode_analysis, then encode_rest (every step's
                      context, the symbols and the indexes on the device),
                      then one fetch and host rANS.
              fused   the same as one call (encode_arrays).
              self_check() certifies split or fused against staged.
  decompress  alternates the same device functions with host rANS decode,
              once per step (the channel-AR recursion is sequential); with
              the encoder's indexes shipped (compress_with_indexes) it
              host-decodes every step first and makes one decode_all call.
  latent      compress_latent / decompress_latent hand off the raw latent
              y instead of a stream.
  many        compress_many / decompress_many code several batches, one
              batch's host coding overlapping another's device work;
              encdec_pipeline is the classic format's serving loop.
  interleaved the device-coding profile: the y streams are K-lane
              interleaved rANS, coded ON THE DEVICE in both directions
              (entropy/device_decode.py). compress_device = a dispatch
              phase that queues everything without waiting for the device
              (analysis, a replay of the decoder's own function, the lane
              encoder) + a fetch phase; compress_interleaved codes the same
              streams with the host coder; decompress_interleaved
              host-decodes the (tiny) z stream and then never waits for
              the device; encdec_pipeline_interleaved is the profile's
              serving loop. Out-of-table symbols ride a patch list of at
              most `patch_cap` entries a step; beyond it (untrained
              weights) the encoders raise rans.EscapeError and the caller
              falls back to the classic format.

A coding step is a slice of the latent's channels (DCAE, TCM) or one
checkerboard pass of a channel group (ELIC): the model's step hooks
(models/base.py) say which part of the latent it codes. A step's
symbols are that part's, and the codec bounds a step's symbols by
B * yh * yw * cfg.slice_dim (`_step_bound`).

Both directions must compute bitwise-equal mu/sigma/indexes on the card,
so the codec turns TF32 off and makes cuDNN deterministic; the two kernels
are deterministic by construction. Symbols are serialized channel-major
(NCHW flatten) per step, the reference's order, and a batch encodes to
one stream per image.

A codec built from half a state dict (models/split.py: no g_s, or no g_a
and h_a) is one half of a split deployment: its model holds only that
half's parameters, and a method that needs the other half raises.

Entry points run on CUDA unless the caller passes device="cpu"; without a
GPU and without device="cpu" they raise.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dcae_tpu_torch.config import DCAEConfig, ELICConfig, TCMConfig
from dcae_tpu_torch.entropy import device_decode, rans
from dcae_tpu_torch.entropy.gaussian import get_scale_table
from dcae_tpu_torch.entropy.tables import CodecTables, build_codec_tables
from dcae_tpu_torch.models.base import HALF_TRANSFORMS, build_model
from dcae_tpu_torch.ops.kernels.rans_lanes import to_u16, to_u32
from dcae_tpu_torch.utils.profiling import count, sinks, span


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA by default; never a silent CPU
    fallback (a CUDA device asked for without a card raises)."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return d


def set_deterministic() -> None:
    """Full-f32 matmuls and convolutions (no TF32) and deterministic cuDNN
    algorithms: encoder and decoder must compute the entropy side's
    mu/sigma bitwise alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _len_bucket(n: int, cap: int) -> int:
    """Smallest of {cap/16, cap/8, cap/4, cap/2, cap} >= n: the word-buffer
    widths the interleaved container records."""
    for d in (16, 8, 4, 2):
        if n <= cap // d:
            return max(cap // d, 1)
    return cap


def _auto_lanes(n_symbols: int) -> int:
    """Lane count for the interleaved profile: enough lanes to keep the
    device loop short (T = n / K steps), few enough that the K uint32
    state header stays a small fraction of the payload."""
    for k in (1024, 512, 256, 128):
        if n_symbols >= k * 256:
            return k
    return 64


def _host(steps):
    """A step array (stacked, or a tuple of the steps') as numpy, alike."""
    if torch.is_tensor(steps):
        return steps.cpu().numpy()
    return [t.cpu().numpy() for t in steps]


def _nchw_flat(x_hwc: np.ndarray) -> np.ndarray:
    """(H, W, C) -> channel-major flat (the reference's symbol order)."""
    return np.ascontiguousarray(x_hwc.transpose(2, 0, 1)).reshape(-1)


def _unflatten_chw(flat: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    return flat.reshape(c, h, w).transpose(1, 2, 0)


class DCAECodec:
    """Owns the model, its coding tables and the host coder's threads."""

    def __init__(self, cfg: Union[DCAEConfig, TCMConfig, ELICConfig],
                 params=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None, patch_cap: int = 512,
                 tables: Optional[CodecTables] = None):
        """cfg: the model's configuration, which chooses the model (DCAE,
        TCM or ELIC, models/base.py: build_model).
        params: a state dict in the port's (= the reference's) naming,
        values numpy arrays or tensors (utils.convert builds one from Flax
        params or a reference checkpoint); None draws a seeded random init.
        A state dict without any g_s.* (or without any g_a.* / h_a.*) keys
        builds that half of a split deployment: the missing transforms are
        never built, and the rest loads strictly.
        tables: coding tables baked elsewhere (the encoder's, for a decoder
        half); update() then has nothing to do unless forced.
        dtype: compute dtype of g_a/h_a/g_s (default from
        cfg.compute_dtype); the entropy side always runs f32.
        patch_cap: most out-of-table symbols a step of the interleaved
        profile may carry in its patch list (also an attribute)."""
        self.device = resolve_device(device)
        set_deterministic()
        if dtype is None:
            dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)
        self.cfg = cfg
        omit = () if params is None else tuple(
            n for n in HALF_TRANSFORMS
            if not any(k.startswith(n + ".") for k in params))
        model = build_model(cfg, omit=omit)
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(
                {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                 for k, v in params.items()}, strict=True)
        self.model = model.set_transform_dtype(dtype).to(self.device).eval()
        self.tables: Optional[CodecTables] = tables
        self._scale_table = torch.as_tensor(
            get_scale_table(cfg.scales_min, cfg.scales_max,
                            cfg.scales_levels), device=self.device)
        # staged by default (encoder and decoder agree by construction);
        # self_check() moves to "split" or "fused" when they bit-match it
        self.encode_mode = "staged"
        # per-image streams are independent; the C coder releases the
        # interpreter lock, so a batch entropy-codes in parallel
        self._pool = ThreadPoolExecutor(max_workers=8)
        self.patch_cap = int(patch_cap)
        # device-resident tables of the interleaved profile, rebuilt when
        # the coding tables change: (tables they were built from, value)
        self._lane_dev = (None, None)         # (tables, (decode, encode))
        self._medians_host = (None, None)     # (tables, numpy medians)

    def close(self) -> None:
        self._pool.shutdown()

    # ------------------------------------------------------------ helpers --

    def _input(self, x) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float in [0, 1] -> f32 on the device;
        uint8 crosses to the device at 1 byte/pixel and is normalized
        there."""
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        t = self._upload(t)
        if t.dtype == torch.uint8:
            return t.to(torch.float32) / 255.0
        return t.to(torch.float32)

    def _upload(self, t) -> torch.Tensor:
        """A host array or tensor onto the device without waiting for it:
        on the card through pinned memory, a copy queued on the current
        stream (a pageable copy would wait for all work queued before
        it)."""
        t = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
        if self.device.type == "cuda" and not t.is_cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @property
    def role(self) -> str:
        """"joint", or the half of a split deployment this codec is:
        "encoder" (no g_s) or "decoder" (no g_a / h_a)."""
        omitted = self.model.omitted
        return ("joint" if not omitted else
                "encoder" if "g_s" in omitted else "decoder")

    def _need(self, what: str, *names: str) -> None:
        """Raise before any work when `what` needs a transform this codec
        does not hold."""
        missing = [n for n in names if n in self.model.omitted]
        if missing:
            raise RuntimeError(
                f"{what} needs {', '.join(missing)}, which this codec does "
                f"not hold: it is the {self.role} half of a split "
                "deployment")

    def _step_bound(self, B: int, y_h: int, y_w: int) -> int:
        """The most symbols one coding step of B images holds."""
        return B * y_h * y_w * self.cfg.slice_dim

    def _require_tables(self) -> CodecTables:
        if self.tables is None:
            raise RuntimeError("call update() before real coding")
        return self.tables

    # ------------------------------------------------------------- public --

    @torch.no_grad()
    def forward(self, x) -> dict:
        """Eval-mode forward pass (likelihoods, no bitstream)."""
        self._need("forward", *HALF_TRANSFORMS)
        return self.model(self._input(x))

    @torch.no_grad()
    def aux_loss(self) -> float:
        """The bottleneck's quantile loss at the current parameters."""
        return float(self.model.aux_loss())

    def update(self, scale_table=None, force: bool = False) -> bool:
        """Bake the integer coding tables from the current parameters (and
        `scale_table`, which then replaces the Gaussian scale table on the
        device too); must precede compress/decompress."""
        if self.tables is not None and not force:
            return False
        if scale_table is not None:
            self._scale_table = torch.as_tensor(
                np.asarray(scale_table, np.float32), device=self.device)
        prefix = "entropy_bottleneck."
        eb = {k[len(prefix):]: v.detach().cpu().numpy()
              for k, v in self.model.state_dict().items()
              if k.startswith(prefix)}
        self.tables = build_codec_tables(
            eb, self._scale_table.cpu().numpy(),
            tail_mass=self.cfg.gc_tail_mass)
        return True

    @property
    def fused_encode(self) -> bool:
        return self.encode_mode == "fused"

    @fused_encode.setter
    def fused_encode(self, v: bool) -> None:
        self.encode_mode = "fused" if v else "staged"

    def _encode_z(self, z_sym: np.ndarray) -> List[bytes]:
        f = self._require_tables().factorized
        B, zh, zw, C = z_sym.shape
        z_index = np.repeat(np.arange(C, dtype=np.int32), zh * zw)
        return list(self._pool.map(
            lambda b: rans.encode_with_indexes(
                _nchw_flat(z_sym[b]), z_index, f.quantized_cdf,
                f.cdf_length, f.offset), range(B)))

    @torch.no_grad()
    def compress(self, x, fused: Optional[bool] = None,
                 mode: Optional[str] = None,
                 record: Optional[list] = None) -> dict:
        """x: (B, H, W, 3) in [0, 1] (float) or uint8, H and W multiples of
        cfg.pad_multiple. Returns {"strings": [y_strings, z_strings],
        "shape": (zh, zw)}.

        mode: "staged", "split" or "fused" (module docstring); default
        self.encode_mode, or fused / staged when `fused` is given. Every
        mode writes the same stream format. record (optional list): gets
        the (indexes, symbols) numpy pair of every step, each in its
        part's shape ((B, yh, yw, sd) for a slice)."""
        self._need("compress", "g_a", "h_a")
        if mode is None:
            mode = (self.encode_mode if fused is None
                    else "fused" if fused else "staged")
        if mode == "staged":
            return self._compress_staged(x, record)
        return self._finish_fused(self._encode_arrays(x, mode), record)

    def _encode_arrays(self, x, mode: str) -> dict:
        """The device side of a split or fused encode: y_symbols and
        y_indexes (the steps', stacked where they share a shape),
        z_symbols (B, zh, zw, C)."""
        model, st = self.model, self._scale_table
        if mode == "fused":
            return model.encode_arrays(self._input(x), st)
        if mode != "split":
            raise ValueError(f"unknown encode mode {mode!r}")
        y, z_symbols, z_hat = model.encode_analysis(self._input(x))
        out = model.encode_rest(y, z_hat, st)
        out["z_symbols"] = z_symbols
        return out

    def _fetch_encode_arrays(self, out: dict):
        """(z_symbols, y_symbols, y_indexes int32) of an encode's arrays as
        numpy: the one hand-off from the device to the host coders (waits
        only for this encode when _copy_to_host started the copies)."""
        if "_ready" in out:
            out["_ready"].synchronize()
        idx = _host(out["y_indexes"])
        return (out["z_symbols"].cpu().numpy(), _host(out["y_symbols"]),
                idx.astype(np.int32) if isinstance(idx, np.ndarray)
                else [i.astype(np.int32) for i in idx])

    def _finish_fused(self, out: dict, record: Optional[list] = None
                      ) -> dict:
        """Host rANS coding of an encode's arrays, fetched at once: one
        stream per image, the steps in order, each channel-major (NCHW),
        exactly as the staged encoder writes them."""
        g = self._require_tables().gaussian
        z_sym, y_sym, y_idx = self._fetch_encode_arrays(out)
        if record is not None:
            record.extend(zip(y_idx, y_sym))
        B, zh, zw, _ = z_sym.shape
        z_strings = self._encode_z(z_sym)

        def encode_one(b: int) -> bytes:
            return rans.encode_with_indexes(
                np.concatenate([_nchw_flat(s[b]) for s in y_sym]),
                np.concatenate([_nchw_flat(i[b]) for i in y_idx]),
                g.quantized_cdf, g.cdf_length, g.offset)

        y_strings = list(self._pool.map(encode_one, range(B)))
        return {"strings": [y_strings, z_strings], "shape": (zh, zw)}

    @torch.no_grad()
    def compress_many(self, batches: Sequence, fused: Optional[bool] = None,
                      mode: Optional[str] = None, pipeline: bool = False
                      ) -> List[dict]:
        """compress() of each batch, in order. pipeline=True (split or
        fused mode): batch n + 1's device work is queued before batch n's
        arrays are host-coded, and each batch's fetch waits for its own
        copies only, so the host coding of one batch overlaps the device
        work of the next. The streams equal compress()'s."""
        if mode is None:
            mode = (self.encode_mode if fused is None
                    else "fused" if fused else "staged")
        if mode == "staged" or not pipeline:
            return [self.compress(x, mode=mode) for x in batches]
        self._need("compress_many", "g_a", "h_a")
        results: List[dict] = []
        pending = None
        for x in list(batches) + [None]:
            out = None if x is None else self._copy_to_host(
                self._encode_arrays(x, mode))
            if pending is not None:
                results.append(self._finish_fused(pending))
            pending = out
        return results

    def _compress_staged(self, x, record: Optional[list]) -> dict:
        """Encode by replaying the decoder's functions, rounding each
        step's symbols on the host against the decoder's own mu."""
        g = self._require_tables().gaussian
        model, st = self.model, self._scale_table
        y, z_sym, z_hat = model.encode_analysis(self._input(x))
        z_np = z_sym.cpu().numpy()
        B, zh, zw, _ = z_np.shape
        z_strings = self._encode_z(z_np)

        ls, lm, support, mu, indexes = model.decode_start(z_hat, st)
        y_parts = [model.step_part(i, y).cpu().numpy()
                   for i in range(model.num_steps)]
        y_hat = torch.zeros((B, *y.shape[1:3], 0), device=self.device)
        sym_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        idx_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        symbols = None
        for i in range(model.num_steps):
            if i > 0:
                y_hat, support, mu, indexes = model.decode_step(
                    i, ls, lm, y_hat, support, mu, symbols, st)
            mu_np = mu.cpu().numpy()
            idx_np = indexes.cpu().numpy()
            sym_np = np.round(y_parts[i] - mu_np).astype(np.int32)
            if record is not None:
                record.append((idx_np, sym_np))
            for b in range(B):
                sym_chunks[b].append(_nchw_flat(sym_np[b]))
                idx_chunks[b].append(_nchw_flat(idx_np[b]))
            symbols = self._upload(sym_np)

        y_strings = list(self._pool.map(
            lambda b: rans.encode_with_indexes(
                np.concatenate(sym_chunks[b]), np.concatenate(idx_chunks[b]),
                g.quantized_cdf, g.cdf_length, g.offset), range(B)))
        return {"strings": [y_strings, z_strings], "shape": (zh, zw)}

    def _decode_z_hat(self, z_strings: Sequence[bytes], zh: int, zw: int
                      ) -> np.ndarray:
        """Host-decode the z streams and dequantize around the medians, as
        the encoder did."""
        t = self._require_tables()
        f = t.factorized
        C = self.cfg.eb_channels
        z_index = np.repeat(np.arange(C, dtype=np.int32), zh * zw)
        src, medians = self._medians_host
        if src is not t:
            # fetched once per table bake: a decode never waits for the
            # device here
            medians = self.model.eb_medians().detach().cpu().numpy()
            self._medians_host = (t, medians)
        z_hat = np.empty((len(z_strings), zh, zw, C), np.float32)
        for b, s in enumerate(z_strings):
            sym = rans.decode_with_indexes(s, z_index, f.quantized_cdf,
                                           f.cdf_length, f.offset)
            z_hat[b] = _unflatten_chw(sym.astype(np.float32), zh, zw, C)
        return z_hat + medians.reshape(1, 1, 1, C)

    def _copy_to_host(self, arrays: dict) -> dict:
        """Start device-to-host copies of `arrays` into pinned memory
        behind an event and return them at once: a later wait
        (_fetch_encode_arrays, _DecodeJob) waits for these copies only,
        not for device work queued after them. On the CPU: as given."""
        if self.device.type != "cuda":
            return arrays
        out = {}
        def pinned(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)

        for k, t in arrays.items():
            out[k] = (tuple(map(pinned, t)) if isinstance(t, tuple)
                      else pinned(t))
        out["_ready"] = torch.cuda.Event()
        out["_ready"].record()
        return out

    class _DecodeJob:
        """One batch's per-step decode as a state machine, so that several
        batches can interleave (decompress_many): while one job's host
        rANS decodes a step, another job's device step runs. Each step's
        indexes are copied to the host as soon as their step is queued."""

        def __init__(self, codec: "DCAECodec", strings, shape,
                     record: Optional[list] = None):
            self.c = codec
            self.g = codec._require_tables().gaussian
            self.lut = self.g.lut   # built once, before the pool reads it
            self.record = record
            y_strings, z_strings = strings
            self.B = len(z_strings)
            zh, zw = int(shape[0]), int(shape[1])
            r = codec.cfg.hyper_ratio
            self.y_h, self.y_w = zh * r, zw * r
            z_hat = codec._upload(codec._decode_z_hat(z_strings, zh, zw))
            self.decoders = []
            for s in y_strings:
                d = rans.RansDecoder()
                d.set_stream(s)
                self.decoders.append(d)
            try:
                (self.ls, self.lm, self.support, self.mu,
                 indexes) = codec.model.decode_start(z_hat,
                                                     codec._scale_table)
            except BaseException:
                self.close()
                raise
            self.idx = codec._copy_to_host({"i": indexes})
            self.y_hat = torch.zeros((self.B, self.y_h, self.y_w, 0),
                                     device=codec.device)
            self.slice = 0
            self.x_hat = None

        def _host_decode(self) -> np.ndarray:
            if "_ready" in self.idx:
                self.idx["_ready"].synchronize()
            idx_np = self.idx["i"].cpu().numpy()
            g = self.g

            def decode_one(b: int) -> np.ndarray:
                flat = self.decoders[b].decode_stream(
                    _nchw_flat(idx_np[b]), g.quantized_cdf, g.cdf_length,
                    g.offset, self.lut)
                return _unflatten_chw(flat, *idx_np.shape[1:])

            sym_np = np.stack(list(self.c._pool.map(decode_one,
                                                    range(self.B))))
            if self.record is not None:
                self.record.append((idx_np, sym_np))
            return sym_np

        def advance(self) -> bool:
            """Host-decode the current step (waits for this job's indexes
            only), then queue the next device step. False when done."""
            if self.x_hat is not None:
                return False
            c = self.c
            symbols = c._upload(self._host_decode())
            i = self.slice + 1
            if i < c.model.num_steps:
                self.y_hat, self.support, self.mu, indexes = \
                    c.model.decode_step(i, self.ls, self.lm, self.y_hat,
                                        self.support, self.mu, symbols,
                                        c._scale_table)
                self.idx = c._copy_to_host({"i": indexes})
                self.slice = i
                return True
            self.x_hat = c.model.decode_end(self.y_hat, self.support,
                                            self.mu, symbols)
            self.close()
            return False

        def close(self) -> None:
            for d in self.decoders:
                d.close()
            self.decoders = []

    @torch.no_grad()
    def decompress(self, strings: Sequence[Sequence[bytes]],
                   shape: Tuple[int, int], indexes=None,
                   record: Optional[list] = None) -> dict:
        """strings: [y_strings, z_strings]; shape: (zh, zw) of z. Returns
        {"x_hat": (B, H, W, 3) f32 tensor in [0, 1] on the device}.
        indexes (optional): the encoder's coding indexes from
        compress_with_indexes, a step's array each; the decoder then
        computes none itself. record (optional list): gets each step's
        (indexes, symbols), as in compress."""
        self._need("decompress", "g_s")
        if indexes is not None:
            return self._decompress_shipped_indexes(strings, shape, indexes,
                                                    record)
        job = self._DecodeJob(self, strings, shape, record)
        try:
            while job.advance():
                pass
        finally:
            job.close()
        return {"x_hat": job.x_hat}

    @torch.no_grad()
    def decompress_many(self, jobs: Sequence, interleave: int = 2
                        ) -> List[dict]:
        """Decode several (strings, shape) jobs, `interleave` at a time:
        one job's host entropy decode overlaps another's device step.
        Returns [{"x_hat"}] in the jobs' order; each x_hat equals
        decompress's."""
        self._need("decompress_many", "g_s")
        results: List[Optional[dict]] = [None] * len(jobs)
        pending = deque(enumerate(jobs))
        active: List[tuple] = []
        try:
            while pending or active:
                while pending and len(active) < max(1, int(interleave)):
                    i, (strings, shape) = pending.popleft()
                    active.append((i, self._DecodeJob(self, strings, shape)))
                still = []
                for i, job in active:
                    if job.advance():
                        still.append((i, job))
                    else:
                        results[i] = {"x_hat": job.x_hat}
                active = still
        finally:
            for _, job in active:
                job.close()
        return results  # type: ignore[return-value]

    def _decompress_shipped_indexes(self, strings, shape, indexes,
                                    record: Optional[list]) -> dict:
        """Host-decode every step under the shipped indexes, then one
        decode_all call: no device-to-host round trip between steps."""
        g = self._require_tables().gaussian
        lut = g.lut
        y_strings, z_strings = strings
        zh, zw = int(shape[0]), int(shape[1])
        # a step's (B, h, w, c) each
        idx = [np.asarray(i).astype(np.int32) for i in indexes]
        z_hat = self._upload(self._decode_z_hat(z_strings, zh, zw))
        ends = np.cumsum([i[0].size for i in idx])[:-1]

        def decode_one(b: int) -> List[np.ndarray]:
            flat = rans.decode_with_indexes(
                y_strings[b], np.concatenate([_nchw_flat(i[b]) for i in idx]),
                g.quantized_cdf, g.cdf_length, g.offset, lut=lut)
            return [_unflatten_chw(part, *i.shape[1:])
                    for part, i in zip(np.split(flat, ends), idx)]

        per_image = list(self._pool.map(decode_one, range(len(z_strings))))
        sym = [np.stack([p[s] for p in per_image]) for s in range(len(idx))]
        if record is not None:
            record.extend(zip(idx, sym))
        symbols = self.model.step_map([self._upload(s) for s in sym])
        return {"x_hat": self.model.decode_all(z_hat, symbols)}

    @torch.no_grad()
    def compress_with_indexes(self, x, record: Optional[list] = None
                              ) -> dict:
        """Fused compress that also returns the encoder's coding indexes,
        uint8, (S, B, yh, yw, sd) for a one-phase model (a list of the
        steps' arrays where their shapes differ), to ship with the streams:
        decompress(..., indexes=...) then decodes in one device call.
        record: as in compress."""
        self._need("compress_with_indexes", "g_a", "h_a")
        out = self._encode_arrays(x, "fused")
        result = self._finish_fused(out, record)
        result["indexes"] = _host(out["y_indexes"])
        return result

    # ------------------------------------------------ interleaved profile --

    def _lane_luts(self):
        """Device-resident row tables of the lane coders, built once per
        table bake (~139 KB for the 64-row Gaussian bank): the decoder's
        (row offsets, table) and the encoder's (table, offsets, maxpos,
        stride), one table for both."""
        t = self._require_tables()
        src, luts = self._lane_dev
        if src is not t:
            g = t.gaussian
            offs, table = device_decode.row_tables_to_device(
                device_decode.build_row_tables(
                    g.quantized_cdf, g.cdf_length, g.offset), self.device)
            maxpos, stride = device_decode.enc_bounds(g.cdf_length)
            luts = ((offs, table), (table, offs, torch.from_numpy(
                maxpos).to(self.device), stride))
            self._lane_dev = (t, luts)
        return luts

    def _slot_luts(self):
        """The lane decoder's tables: (row offsets, table)."""
        return self._lane_luts()[0]

    def _enc_luts(self):
        """The lane encoder's tables: (table, offsets, maxpos, stride)."""
        return self._lane_luts()[1]

    def compress_device(self, x, lanes: Optional[int] = None,
                        chain: bool = True) -> dict:
        """Encode into the interleaved profile with the y streams coded ON
        THE DEVICE: the host fetches streams of entropy size instead of raw
        symbols. Decodes with decompress_interleaved; the streams equal
        compress_interleaved's bit for bit.

        Out-of-table Gaussian-tail symbols (the ones the classic format
        bypass-codes) ride a per-step patch list: clamped in the stream,
        the exact value restored after the device's entropy decode. Raises
        rans.EscapeError when a step has more of them than self.patch_cap
        (untrained weights) or a symbol's row has no in-range bucket at
        all: fall back to the classic format.

        The encoder teacher-forces THE DECODER'S OWN function
        (DCAE.decode_device_streams, override=True) with the raw latent y.
        That replay is the encoder's only channel-AR pass: it yields the
        symbols (round(y - mu) under the decoder's own mu) and the coding
        indexes, and the lane encoder then codes exactly that pair. The
        same functions at the same shapes run the same kernels and cuDNN
        algorithms (set_deterministic), so the real decode reproduces the
        chain by induction, and `ok` still catches a decoder that diverges.

        chain: one lane-state set for all steps (DTI2) or one a step
        (DTI1).

        Two phases, so that a serving loop can overlap batch i's fetch with
        batch i + 1's device work: _compress_device_dispatch queues
        everything and never waits for the device; _compress_device_fetch
        waits once and codes z on the host."""
        self._need("compress_device", "g_a", "h_a")
        return self._compress_device_fetch(
            self._compress_device_dispatch(x, lanes, chain))

    @torch.no_grad()
    def _compress_device_dispatch(self, x, lanes: Optional[int] = None,
                                  chain: bool = True) -> dict:
        """Phase 1 of compress_device: queue this batch's device work
        (analysis -> replay of the decoder's function -> lane encoder);
        returns the pending handle _compress_device_fetch completes. Waits
        for the device nowhere when x already lies on it."""
        with span("codec.encode.dispatch"):
            model, st = self.model, self._scale_table
            x = self._input(x)
            enc_sf, offs, maxpos, stride = self._enc_luts()
            B, H, W = x.shape[0], x.shape[1], x.shape[2]
            yd = self.cfg.y_downsample
            n_step = self._step_bound(B, H // yd, W // yd)
            K = int(lanes or _auto_lanes(n_step))
            y, z_symbols, z_hat = model.encode_analysis(x)
            _, _, idxs, syms = model.decode_device_streams(
                z_hat, None, None, None, None, None, True, y, None, None,
                st, chain)
            res = device_decode.encode_slices_with_patches(
                syms, idxs, enc_sf, offs, maxpos, stride, K, self.patch_cap,
                chain=chain)
            # the word and patch counts and the flags
            head = torch.cat([
                res["n_words"], res["patch_count"],
                torch.stack([res["escape"], res["patch_overflow"]]).to(
                    torch.int32)])
            # every buffer the container may need, copied whole (the words:
            # 2 bytes a symbol) behind one event, so that the fetch waits for
            # these copies only and not for work queued after them
            host = self._copy_to_host({
                "head": head, "words": res["words"], "states": res["states"],
                "patch_pos": res["patch_pos"], "patch_val": res["patch_val"],
                "z_symbols": z_symbols})
            return {"host": host, "head": head, "cap": n_step + 1, "K": K,
                    "chain": bool(chain)}

    def _compress_device_fetch(self, pend: dict) -> dict:
        """Phase 2 of compress_device: wait for the dispatch's copies to
        the host, then cut the streams' words, the states, patches and z
        symbols to their counts and code z on the host. Raises
        rans.EscapeError."""
        host = pend["host"]
        with span("codec.encode.wait"):
            if "_ready" in host:
                host["_ready"].synchronize()
        with span("codec.encode.host"):
            S = self.model.num_steps
            head = host["head"].numpy()
            n_words, pcnt = head[:S], head[S:2 * S]
            if head[2 * S]:
                raise rans.EscapeError(
                    "symbol outside in-range CDF buckets (device encode)")
            if head[2 * S + 1]:
                raise rans.EscapeError(
                    f"escape patch list overflow (> {self.patch_cap}/step)")
            if sinks:
                count("codec.patched_symbols", int(pcnt.sum()))
            words = to_u16(host["words"][:, :max(int(n_words.max()), 1)])
            n_patch = int(pcnt.max())
            ppos = host["patch_pos"][:, :n_patch].numpy()
            pval = host["patch_val"][:, :n_patch].numpy()
            z_sym = host["z_symbols"].numpy()
            return {
                # emission order reversed is the order the decoder reads
                "istreams": [words[s, :int(n_words[s])][::-1].tobytes()
                             for s in range(S)],
                "states": to_u32(host["states"]),
                "patches": [(ppos[s, :int(pcnt[s])].copy(),
                             pval[s, :int(pcnt[s])].copy()) for s in range(S)],
                # the container's field, as the JAX package's compress_device
                # writes it: the word-buffer bucket, its decode loop's unroll
                # and slot-table layout (constants here: they shaped the JAX
                # decode program and change no bit), and the lane-set layout
                # (DTI1 / DTI2)
                "bucket": _len_bucket(int(n_words.max()), pend["cap"]),
                "unroll": 2,
                "paired": True,
                "chained": pend["chain"],
                "z_strings": self._encode_z(z_sym),
                "shape": (z_sym.shape[1], z_sym.shape[2]),
                "lanes": pend["K"],
            }

    @torch.no_grad()
    def compress_interleaved(self, x, lanes: Optional[int] = None,
                             chain: bool = True) -> dict:
        """Encode into the interleaved profile with the HOST coder (C++
        encode_interleaved): per-step interleaved y streams + a classic z
        stream, bit-identical to compress_device's, clamping and patches
        included. The dict carries no bucket / unroll / paired (0 in the
        container). Raises rans.EscapeError on patch-list overflow or a row
        without in-range buckets.

        Payload overhead against classic: ONE K-uint32 lane-state header
        for the whole chain (chain=False: one a step, the DTI1 layout)
        and 8 bytes per escape patch."""
        self._need("compress_interleaved", "g_a", "h_a")
        g = self._require_tables().gaussian
        mode = "fused" if self.encode_mode == "fused" else "split"
        z_sym, y_sym, y_idx = self._fetch_encode_arrays(
            self._encode_arrays(x, mode))
        z_strings = self._encode_z(z_sym)
        S = len(y_sym)
        r = self.cfg.hyper_ratio
        K = int(lanes or _auto_lanes(self._step_bound(
            z_sym.shape[0], z_sym.shape[1] * r, z_sym.shape[2] * r)))
        row_off = np.asarray(g.offset, np.int32)
        row_mp = np.asarray(g.cdf_length, np.int32) - 2   # in-range buckets

        def clamp_slice(s: int):
            sym = y_sym[s].reshape(-1).astype(np.int32)
            idx = y_idx[s].reshape(-1)
            offs, mp = row_off[idx], row_mp[idx]
            csym = np.clip(sym - offs, 0, np.maximum(mp - 1, 0)) + offs
            pos = np.flatnonzero(csym != sym).astype(np.int32)
            if pos.size > self.patch_cap:
                raise rans.EscapeError(
                    f"escape patch list overflow (> {self.patch_cap}"
                    "/step)")
            return csym, idx, (pos, sym[pos])

        clamped = list(self._pool.map(clamp_slice, range(S)))
        tables = (g.quantized_cdf, g.cdf_length, g.offset)
        if chain:
            # sequential by construction: step s starts from step s+1's
            # final states (the decoder threads them forward)
            streams: list = [None] * S
            states = None
            for s in reversed(range(S)):
                csym, idx, _ = clamped[s]
                streams[s], states = rans.encode_interleaved(
                    csym, idx, *tables, K, init_states=states)
        else:
            pairs = list(self._pool.map(
                lambda s: rans.encode_interleaved(
                    clamped[s][0], clamped[s][1], *tables, K), range(S)))
            streams = [p[0] for p in pairs]
            states = np.stack([p[1] for p in pairs])
        return {
            "istreams": streams,
            "states": np.asarray(states),
            "patches": [c[2] for c in clamped],
            "chained": bool(chain),
            "z_strings": z_strings,
            "shape": (z_sym.shape[1], z_sym.shape[2]),
            "lanes": K,
        }

    def decompress_interleaved(self, enc: dict) -> dict:
        """Decode the interleaved profile: host-decode the (tiny) z stream,
        pad and upload the streams, then the device does the rest and the
        host waits for it nowhere: step contexts + lane decoder
        (DCAE.decode_device_streams, the function the certified encode
        replayed), then synthesis. Returns {"x_hat", "ok"}; ok is a ()
        bool tensor on the device, the lanes checksum (False on a corrupt
        stream or an encoder / decoder divergence)."""
        self._need("decompress_interleaved", "g_s")
        return self._decompress_interleaved_device(
            *self._interleaved_inputs(enc))

    def _interleaved_inputs(self, enc: dict) -> tuple:
        """The host part of decompress_interleaved: the arguments of
        _decompress_interleaved_device, tensors on the device; z_hat is
        uploaded last."""
        with span("codec.decode.host"):
            zh, zw = int(enc["shape"][0]), int(enc["shape"][1])
            streams = enc["istreams"]
            S = len(streams)
            states = np.array(enc["states"], np.uint32)    # a writable copy
            n_words = np.array([len(b) // 2 for b in streams], np.int32)
            words = np.zeros((S, max(int(n_words.max()), 1)), np.uint16)
            for s, b in enumerate(streams):
                words[s, :n_words[s]] = np.frombuffer(b, np.uint16)
            # the container's unroll field (0: unspecified) is validated and
            # otherwise unused, like its slot-table layout: both shaped the
            # JAX decode program and change no symbol
            unroll = int(enc.get("unroll") or 0)
            if unroll not in (0, 1, 2, 4, 8, 16, 32, 64):
                raise ValueError(f"interleaved stream: unroll {unroll}")
            # a 1-D state vector IS the chain header (the dict's flag wins)
            chained = bool(enc.get("chained", states.ndim == 1))
            if states.shape != ((int(enc["lanes"]),) if chained
                                else (S, int(enc["lanes"]))):
                raise ValueError(
                    f"interleaved stream: states {states.shape} for "
                    f"{enc['lanes']} lanes, chained {chained}")
            # escape patches, padded to the longest list; padding rows hold a
            # position past every step's symbols, which the scatter drops
            r = self.cfg.hyper_ratio
            n_flat = self._step_bound(len(enc["z_strings"]), zh * r, zw * r)
            patches = enc.get("patches") or []
            P = max([len(p[0]) for p in patches], default=0)
            ppos = np.full((S, P), n_flat, np.int32)
            pval = np.zeros((S, P), np.int32)
            for s, (pos, val) in enumerate(patches):
                ppos[s, :len(pos)] = pos
                pval[s, :len(val)] = val
            z_hat = self._decode_z_hat(enc["z_strings"], zh, zw)
            luts = self._slot_luts()
            up = self._upload
            return (up(words.view(np.int16)), up(n_words),
                    up(states.view(np.int32)), up(ppos), up(pval), luts,
                    chained, up(z_hat))

    @torch.no_grad()
    def _decompress_interleaved_device(self, words, n_words, states, ppos,
                                       pval, luts, chained: bool, z_hat
                                       ) -> dict:
        """The device part of decompress_interleaved: queues everything and
        waits for the device nowhere."""
        with span("codec.decode.dispatch"):
            y_hat, ok, _, _ = self.model.decode_device_streams(
                z_hat, words, n_words, states, ppos, pval, False, None,
                luts[0], luts[1], self._scale_table, chained)
            return {"x_hat": self.model.decode_synthesis(y_hat), "ok": ok}

    # ------------------------------------------------------- serving loop --
    # The JAX package's loops run a producer thread that encodes ahead
    # while the caller decodes. Here a pair of calls is host-bound (eager
    # launches under one interpreter lock; the host never waits for the
    # device in a sequential interleaved pair), and such a producer, on its
    # own stream, with the fetch behind an event and one or two batches
    # dispatched ahead, still lost to sequential calls on an H100 (PERF.md
    # §6): the loops are plain loops over those calls.

    def encdec_pipeline(self, batches: Sequence) -> List[dict]:
        """Serving loop of the classic format: compress() then decompress()
        of each batch, in order. Returns per-batch {"strings", "shape",
        "x_hat"}."""
        self._need("encdec_pipeline", *HALF_TRANSFORMS)
        results: List[dict] = []
        for x in batches:
            enc = self.compress(x)
            results.append({
                "strings": enc["strings"], "shape": enc["shape"],
                "x_hat": self.decompress(enc["strings"],
                                         enc["shape"])["x_hat"]})
        return results

    def encdec_pipeline_interleaved(self, batches: Sequence) -> List[dict]:
        """Serving loop of the device-coding profile: compress_device then
        decompress_interleaved of each batch, in order. A batch whose
        symbols do not fit the profile (rans.EscapeError: untrained
        weights, extreme inputs) is coded by the classic codec instead and
        tagged: every batch gets a result, in order. Returns per-batch
        {"x_hat", "ok", "shape", "profile"}, profile "interleaved" or
        "classic". The next batch's fetch waits for this batch's decode,
        queued before it on the stream."""
        self._need("encdec_pipeline_interleaved", *HALF_TRANSFORMS)
        results: List[dict] = []
        for x in batches:
            x = self._input(x)
            try:
                enc = self.compress_device(x)
            except rans.EscapeError:
                c = self.compress(x)
                d = self.decompress(c["strings"], c["shape"])
                results.append({"x_hat": d["x_hat"], "ok": True,
                                "shape": c["shape"], "profile": "classic"})
                continue
            results.append({**self.decompress_interleaved(enc),
                            "shape": enc["shape"], "profile": "interleaved"})
        return results

    # ----------------------------------------------------- certification --

    def self_check(self, image=None, prefer_fused: bool = False) -> bool:
        """Compress one image with the one-fetch encoder modes and switch
        encode_mode to the first whose stream is certified against the
        staged (decoder-replay) encoder. Returns True when split or fused
        is now on, False (and staged) otherwise.

        Criteria, per mode: (1) the stream equals the staged encoder's,
        byte for byte; (2) for fused, failing that: the staged decoder,
        run on the candidate stream, reproduces the encoder's indexes and
        symbols at every step (_roundtrip_check). split goes first, unless
        prefer_fused (the one-call encoder) asks for fused, which then gets
        criterion 2 before split is tried."""
        self._need("self_check", "g_a", "h_a")
        if image is None:
            p = self.cfg.pad_multiple
            image = np.random.default_rng(0).uniform(
                0, 1, (1, p, p, self.cfg.in_channels)).astype(np.float32)
        staged = self.compress(image, mode="staged")
        modes = ("fused", "split") if prefer_fused else ("split", "fused")
        fused_rt_tried = False
        for mode in modes:
            if self.compress(image, mode=mode)["strings"] \
                    == staged["strings"]:
                self.encode_mode = mode
                return True
            if mode == "fused" and prefer_fused and \
                    "g_s" not in self.model.omitted:
                fused_rt_tried = True
                if self._roundtrip_check(image, mode="fused"):
                    self.encode_mode = "fused"
                    return True
        # criterion 2 decodes: an encoder half certifies by criterion 1 only
        if not fused_rt_tried and "g_s" not in self.model.omitted and \
                self._roundtrip_check(image, mode="fused"):
            self.encode_mode = "fused"
            return True
        self.encode_mode = "staged"
        return False

    @torch.no_grad()
    def _roundtrip_check(self, image, mode: str = "fused") -> bool:
        """Criterion 2: encode `image` in `mode`, decode the stream with the
        per-step decoder and require its (indexes, symbols) to equal the
        encoder's at every step, bitwise."""
        enc_rec: list = []
        enc = self._finish_fused(self._encode_arrays(image, mode), enc_rec)
        dec_rec: list = []
        self.decompress(enc["strings"], enc["shape"], record=dec_rec)
        return len(dec_rec) == len(enc_rec) and all(
            np.array_equal(di.astype(np.int32), ei)
            and np.array_equal(ds.astype(np.int32), es)
            for (ei, es), (di, ds) in zip(enc_rec, dec_rec))

    # -------------------------------------------------------- latent path --

    @torch.no_grad()
    def compress_latent(self, x) -> np.ndarray:
        """Latent hand-off encode: the raw latent y (B, yh, yw, M) f32, no
        entropy coding."""
        self._need("compress_latent", "g_a")
        return self.model.analysis(self._input(x)).cpu().numpy()

    @torch.no_grad()
    def decompress_latent(self, y) -> dict:
        """Latent hand-off decode (model.latent_decompress: it derives z
        again, so it needs h_a beside g_s)."""
        self._need("decompress_latent", "h_a", "g_s")
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        return {"x_hat": self.model.latent_decompress(y)}

    def analyze_sizes(self, x) -> dict:
        """Bytes of the coded streams against the image, the raw latent and
        the model. model_params counts what this codec holds: the encoder
        half's own parameters when it is one."""
        self._need("analyze_sizes", "g_a", "h_a")
        x = np.asarray(x)
        enc = self.compress(x)
        y = self.compress_latent(x)
        y_bytes = sum(len(s) for s in enc["strings"][0])
        z_bytes = sum(len(s) for s in enc["strings"][1])
        n_params = sum(p.numel() for p in self.model.parameters())
        return {
            "image_bytes_uint8": int(np.prod(x.shape)),
            "y_string_bytes": y_bytes,
            "z_string_bytes": z_bytes,
            "total_stream_bytes": y_bytes + z_bytes,
            "raw_latent_bytes_f32": int(np.prod(y.shape) * 4),
            "raw_latent_bytes_bf16": int(np.prod(y.shape) * 2),
            "stream_vs_image_ratio": float(np.prod(x.shape))
            / (y_bytes + z_bytes),
            "model_params": n_params,
            "model_bytes_f32": n_params * 4,
        }
