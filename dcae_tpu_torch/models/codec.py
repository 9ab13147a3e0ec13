"""Host codec driver: real bitstream compress() / decompress().

  compress    three encoder modes, one stream format:
              staged  g_a + h_a once, then the encoder REPLAYS the
                      decoder's own functions (decode_start / decode_step)
                      slice by slice and rounds each slice's symbols on the
                      host against the decoder's mu: the mu/sigma/indexes
                      it codes under are the ones the decoder will compute.
                      One device-to-host round trip per slice.
              split   encode_analysis, then encode_rest (every slice
                      context, the symbols and the indexes on the device),
                      then one fetch and host rANS.
              fused   the same as one call (encode_arrays).
              self_check() certifies split or fused against staged.
  decompress  alternates the same device functions with host rANS decode,
              once per slice (the channel-AR recursion is sequential); with
              the encoder's indexes shipped (compress_with_indexes) it
              host-decodes every slice first and makes one decode_all call.
  latent      compress_latent / decompress_latent hand off the raw latent
              y instead of a stream.

Both directions must compute bitwise-equal mu/sigma/indexes on the card,
so the codec turns TF32 off and makes cuDNN deterministic; the two kernels
are deterministic by construction. Symbols are serialized channel-major
(NCHW flatten) per slice, the reference's order, and a batch encodes to
one stream per image.

Entry points run on CUDA unless the caller passes device="cpu"; without a
GPU and without device="cpu" they raise.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dcae_tpu_torch.config import DCAEConfig
from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.entropy.gaussian import get_scale_table
from dcae_tpu_torch.entropy.tables import CodecTables, build_codec_tables
from dcae_tpu_torch.models.dcae import DCAE


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA by default; never a silent CPU
    fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_deterministic() -> None:
    """Full-f32 matmuls and convolutions (no TF32) and deterministic cuDNN
    algorithms: encoder and decoder must compute the entropy side's
    mu/sigma bitwise alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _nchw_flat(x_hwc: np.ndarray) -> np.ndarray:
    """(H, W, C) -> channel-major flat (the reference's symbol order)."""
    return np.ascontiguousarray(x_hwc.transpose(2, 0, 1)).reshape(-1)


def _unflatten_chw(flat: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    return flat.reshape(c, h, w).transpose(1, 2, 0)


class DCAECodec:
    """Owns the model, its coding tables and the host coder's threads."""

    def __init__(self, cfg: DCAEConfig, params=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 device=None):
        """params: a state dict in the port's (= the reference's) naming,
        values numpy arrays or tensors (utils.convert builds one from Flax
        params or a reference checkpoint); None draws a seeded random init.
        dtype: compute dtype of g_a/h_a/g_s (default from
        cfg.compute_dtype); the entropy side always runs f32."""
        self.device = resolve_device(device)
        set_deterministic()
        if dtype is None:
            dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)
        self.cfg = cfg
        model = DCAE(cfg)
        if params is None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(
                {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                 for k, v in params.items()}, strict=True)
        self.model = model.set_transform_dtype(dtype).to(self.device).eval()
        self.tables: Optional[CodecTables] = None
        self._scale_table = torch.as_tensor(
            get_scale_table(cfg.scales_min, cfg.scales_max,
                            cfg.scales_levels), device=self.device)
        # staged by default (encoder and decoder agree by construction);
        # self_check() moves to "split" or "fused" when they bit-match it
        self.encode_mode = "staged"
        # per-image streams are independent; the C coder releases the
        # interpreter lock, so a batch entropy-codes in parallel
        self._pool = ThreadPoolExecutor(max_workers=8)

    def close(self) -> None:
        self._pool.shutdown()

    # ------------------------------------------------------------ helpers --

    def _input(self, x) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float in [0, 1] -> f32 on the device;
        uint8 crosses to the device at 1 byte/pixel and is normalized
        there."""
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        t = t.to(self.device)
        if t.dtype == torch.uint8:
            return t.to(torch.float32) / 255.0
        return t.to(torch.float32)

    def _require_tables(self) -> CodecTables:
        if self.tables is None:
            raise RuntimeError("call update() before real coding")
        return self.tables

    # ------------------------------------------------------------- public --

    @torch.no_grad()
    def forward(self, x) -> dict:
        """Eval-mode forward pass (likelihoods, no bitstream)."""
        return self.model(self._input(x))

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
        the (indexes, symbols) numpy pair of every slice, (B, yh, yw, sd)
        each."""
        if mode is None:
            mode = (self.encode_mode if fused is None
                    else "fused" if fused else "staged")
        if mode == "staged":
            return self._compress_staged(x, record)
        return self._finish_fused(self._encode_arrays(x, mode), record)

    def _encode_arrays(self, x, mode: str) -> dict:
        """The device side of a split or fused encode: y_symbols and
        y_indexes (S, B, yh, yw, sd), z_symbols (B, zh, zw, C)."""
        model, st = self.model, self._scale_table
        if mode == "fused":
            return model.encode_arrays(self._input(x), st)
        if mode != "split":
            raise ValueError(f"unknown encode mode {mode!r}")
        y, z_symbols, z_hat = model.encode_analysis(self._input(x))
        out = model.encode_rest(y, z_hat, st)
        out["z_symbols"] = z_symbols
        return out

    def _finish_fused(self, out: dict, record: Optional[list] = None
                      ) -> dict:
        """Host rANS coding of an encode's arrays, fetched at once: one
        stream per image, the slices in order, each channel-major (NCHW),
        exactly as the staged encoder writes them."""
        g = self._require_tables().gaussian
        z_sym = out["z_symbols"].cpu().numpy()
        y_sym = out["y_symbols"].cpu().numpy()
        y_idx = out["y_indexes"].cpu().numpy().astype(np.int32)
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

    def _compress_staged(self, x, record: Optional[list]) -> dict:
        """Encode by replaying the decoder's functions, rounding each
        slice's symbols on the host against the decoder's own mu."""
        g = self._require_tables().gaussian
        model, st, sd = self.model, self._scale_table, self.cfg.slice_dim
        y, z_sym, z_hat = model.encode_analysis(self._input(x))
        z_np = z_sym.cpu().numpy()
        B, zh, zw, _ = z_np.shape
        z_strings = self._encode_z(z_np)

        ls, lm, support, mu, indexes = model.decode_start(z_hat, st)
        y_np = y.cpu().numpy()
        y_hat = torch.zeros((B, *y.shape[1:3], 0), device=self.device)
        sym_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        idx_chunks: List[List[np.ndarray]] = [[] for _ in range(B)]
        symbols = None
        for i in range(self.cfg.num_slices):
            if i > 0:
                y_hat, support, mu, indexes = model.decode_step(
                    i, ls, lm, y_hat, support, mu, symbols, st)
            mu_np = mu.cpu().numpy()
            idx_np = indexes.cpu().numpy()
            sym_np = np.round(y_np[..., i * sd:(i + 1) * sd] - mu_np
                              ).astype(np.int32)
            if record is not None:
                record.append((idx_np, sym_np))
            for b in range(B):
                sym_chunks[b].append(_nchw_flat(sym_np[b]))
                idx_chunks[b].append(_nchw_flat(idx_np[b]))
            symbols = torch.as_tensor(sym_np, device=self.device)

        y_strings = list(self._pool.map(
            lambda b: rans.encode_with_indexes(
                np.concatenate(sym_chunks[b]), np.concatenate(idx_chunks[b]),
                g.quantized_cdf, g.cdf_length, g.offset), range(B)))
        return {"strings": [y_strings, z_strings], "shape": (zh, zw)}

    def _decode_z_hat(self, z_strings: Sequence[bytes], zh: int, zw: int
                      ) -> np.ndarray:
        """Host-decode the z streams and dequantize around the medians, as
        the encoder did."""
        f = self._require_tables().factorized
        C = self.cfg.eb_channels
        z_index = np.repeat(np.arange(C, dtype=np.int32), zh * zw)
        medians = self.model.eb_medians().detach().cpu().numpy()
        z_hat = np.empty((len(z_strings), zh, zw, C), np.float32)
        for b, s in enumerate(z_strings):
            sym = rans.decode_with_indexes(s, z_index, f.quantized_cdf,
                                           f.cdf_length, f.offset)
            z_hat[b] = _unflatten_chw(sym.astype(np.float32), zh, zw, C)
        return z_hat + medians.reshape(1, 1, 1, C)

    @torch.no_grad()
    def decompress(self, strings: Sequence[Sequence[bytes]],
                   shape: Tuple[int, int], indexes=None,
                   record: Optional[list] = None) -> dict:
        """strings: [y_strings, z_strings]; shape: (zh, zw) of z. Returns
        {"x_hat": (B, H, W, 3) f32 tensor in [0, 1] on the device}.
        indexes (optional): the encoder's coding indexes (S, B, yh, yw, sd)
        from compress_with_indexes; the decoder then computes none itself.
        record (optional list): gets each slice's (indexes, symbols), as in
        compress."""
        if indexes is not None:
            return self._decompress_shipped_indexes(strings, shape, indexes,
                                                    record)
        g = self._require_tables().gaussian
        lut = g.lut   # built once, before the pool's threads read it
        model, st, sd = self.model, self._scale_table, self.cfg.slice_dim
        y_strings, z_strings = strings
        B = len(z_strings)
        zh, zw = int(shape[0]), int(shape[1])
        y_h, y_w = zh * self.cfg.hyper_ratio, zw * self.cfg.hyper_ratio
        z_hat = torch.as_tensor(self._decode_z_hat(z_strings, zh, zw),
                                device=self.device)
        decoders = []
        for s in y_strings:
            d = rans.RansDecoder()
            d.set_stream(s)
            decoders.append(d)

        def decode_one(b: int, idx_np: np.ndarray) -> np.ndarray:
            flat = decoders[b].decode_stream(
                _nchw_flat(idx_np[b]), g.quantized_cdf, g.cdf_length,
                g.offset, lut)
            return _unflatten_chw(flat, y_h, y_w, sd)

        try:
            ls, lm, support, mu, indexes = model.decode_start(z_hat, st)
            y_hat = torch.zeros((B, y_h, y_w, 0), device=self.device)
            for i in range(self.cfg.num_slices):
                idx_np = indexes.cpu().numpy()
                sym_np = np.stack(list(self._pool.map(
                    lambda b: decode_one(b, idx_np), range(B))))
                if record is not None:
                    record.append((idx_np, sym_np))
                symbols = torch.as_tensor(sym_np, device=self.device)
                if i + 1 < self.cfg.num_slices:
                    y_hat, support, mu, indexes = model.decode_step(
                        i + 1, ls, lm, y_hat, support, mu, symbols, st)
                else:
                    x_hat = model.decode_end(y_hat, support, mu, symbols)
        finally:
            for d in decoders:
                d.close()
        return {"x_hat": x_hat}

    def _decompress_shipped_indexes(self, strings, shape, indexes,
                                    record: Optional[list]) -> dict:
        """Host-decode every slice under the shipped indexes, then one
        decode_all call: no device-to-host round trip between slices."""
        g = self._require_tables().gaussian
        lut = g.lut
        y_strings, z_strings = strings
        zh, zw = int(shape[0]), int(shape[1])
        y_h, y_w = zh * self.cfg.hyper_ratio, zw * self.cfg.hyper_ratio
        sd, S = self.cfg.slice_dim, self.cfg.num_slices
        idx = np.asarray(indexes).astype(np.int32)    # (S, B, yh, yw, sd)
        z_hat = torch.as_tensor(self._decode_z_hat(z_strings, zh, zw),
                                device=self.device)
        per = y_h * y_w * sd

        def decode_one(b: int) -> np.ndarray:
            flat = rans.decode_with_indexes(
                y_strings[b], np.concatenate([_nchw_flat(i[b]) for i in idx]),
                g.quantized_cdf, g.cdf_length, g.offset, lut=lut)
            return np.stack([_unflatten_chw(flat[s * per:(s + 1) * per],
                                            y_h, y_w, sd) for s in range(S)])

        # (S, B, yh, yw, sd)
        sym = np.stack(list(self._pool.map(decode_one, range(len(z_strings)))),
                       axis=1)
        if record is not None:
            record.extend(zip(idx, sym))
        symbols = torch.as_tensor(np.concatenate(list(sym), axis=-1),
                                  device=self.device)
        return {"x_hat": self.model.decode_all(z_hat, symbols)}

    @torch.no_grad()
    def compress_with_indexes(self, x) -> dict:
        """Fused compress that also returns the encoder's coding indexes,
        (S, B, yh, yw, sd) uint8, to ship with the streams:
        decompress(..., indexes=...) then decodes in one device call."""
        out = self._encode_arrays(x, "fused")
        result = self._finish_fused(out)
        result["indexes"] = out["y_indexes"].cpu().numpy()
        return result

    # ----------------------------------------------------- certification --

    def self_check(self, image=None, prefer_fused: bool = False) -> bool:
        """Compress one image with the one-fetch encoder modes and switch
        encode_mode to the first whose stream is certified against the
        staged (decoder-replay) encoder. Returns True when split or fused
        is now on, False (and staged) otherwise.

        Criteria, per mode: (1) the stream equals the staged encoder's,
        byte for byte; (2) for fused, failing that: the staged decoder,
        run on the candidate stream, reproduces the encoder's indexes and
        symbols at every slice (_roundtrip_check). split goes first, unless
        prefer_fused (the one-call encoder) asks for fused, which then gets
        criterion 2 before split is tried."""
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
            if mode == "fused" and prefer_fused:
                fused_rt_tried = True
                if self._roundtrip_check(image, mode="fused"):
                    self.encode_mode = "fused"
                    return True
        if not fused_rt_tried and self._roundtrip_check(image, mode="fused"):
            self.encode_mode = "fused"
            return True
        self.encode_mode = "staged"
        return False

    @torch.no_grad()
    def _roundtrip_check(self, image, mode: str = "fused") -> bool:
        """Criterion 2: encode `image` in `mode`, decode the stream with the
        per-slice decoder and require its (indexes, symbols) to equal the
        encoder's at every slice, bitwise."""
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
        return self.model.analysis(self._input(x)).cpu().numpy()

    @torch.no_grad()
    def decompress_latent(self, y) -> dict:
        """Latent hand-off decode (DCAE.latent_decompress)."""
        y = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        return {"x_hat": self.model.latent_decompress(y)}

    def analyze_sizes(self, x) -> dict:
        """Bytes of the coded streams against the image, the raw latent and
        the model."""
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
