"""The channel-autoregressive codec model that DCAE and TCM share.

    forward(x) -> {x_hat, likelihoods{y, z}, para{means, scales, y, ...}}

ChannelARModel holds everything of a model but its transforms and its
slice contexts: the entropy bottleneck over z, the slice loop of the
training forward, the LRP application, and every real-codec piece the
codec driver calls (models/codec.py). A model subclasses it with g_a,
h_a, g_s, `hyper_synthesis` (z_hat -> (latent_scales, latent_means)),
`_slice_context` (slice i's (support, mu, sigma) from those and the
earlier slices) and `lrp_transforms` (slice i's LRP net, fed the support
and the slice); `_slice_lrp` may be overridden. `build_model` picks the
model a configuration names.

forward(x, training=True, generator=g) is the training forward: additive
uniform noise in place of rounding for the likelihoods, and, with
cfg.drift_noise > 0, uniform drift noise on the decoder-side support, mu,
sigma and the transferred z_hat; all noise comes from the one explicit
torch.Generator `g` (on x's device). decode_from_quantized is the decoder
half on an already quantized latent (the precision-regularization pass) and
aux_loss the bottleneck's quantile loss.

Plus the pieces the real codec drives: encode_analysis, encode_rest /
encode_arrays (the split and fused encoders), decode_start / decode_step /
decode_end (the per-slice decoder, which the staged encoder replays),
decode_all (the shipped-index decoder), latent_decompress (the latent
hand-off) and decode_device_streams (the interleaved profile: the y
streams are entropy-decoded on the device, and the device encoder replays
the same pass; on the card it replays a CUDA graph,
models/entropy_graph.py).
Tensors are NHWC, as in the JAX package.

Precision split: `dtype` (bf16 on the card) applies only to the one-sided
transforms g_a / h_a (encoder) and g_s (decoder); their outputs are cast to
f32 and quantized once, so their rounding cannot make encoder and decoder
disagree. The entropy-side nets (the hyper synthesis, the slice contexts,
the LRP) always run f32: encoder and decoder must reproduce mu, sigma and
the LRP bitwise, and both call the same functions here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dcae_tpu_torch.entropy import gaussian
from dcae_tpu_torch.entropy.bottleneck import EntropyBottleneck
from dcae_tpu_torch.entropy.ops import draw_noise, ste_round
from dcae_tpu_torch.models import entropy_graph
from dcae_tpu_torch.models.transforms import GAnalysis, GSynthesis
from dcae_tpu_torch.ops.blocks import WMSA, Scale
from dcae_tpu_torch.ops.dictionary import DictionaryCrossAttention
from dcae_tpu_torch.ops.layers import reset_layer, trunc_normal_
from dcae_tpu_torch.ops.tcm_blocks import GDN
from dcae_tpu_torch.parallel import spatial


# the one-sided transforms a half of a split deployment may leave out
HALF_TRANSFORMS = ("g_a", "h_a", "g_s")


class MissingTransform(nn.Module):
    """Stands in for a transform this model does not hold (one half of a
    split deployment): no parameters, and calling it raises."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            f"this model holds no {self.name}: it is one half of a split "
            "deployment (models/split.py)")


@torch.no_grad()
def reset_modules(module: nn.Module, generator: torch.Generator) -> None:
    """The layers' part of a model's reset_parameters, for any module built
    of the port's layers, in module order."""
    for m in module.modules():
        reset_layer(m, generator)
        if isinstance(m, WMSA):
            trunc_normal_(m.relative_position_params, 0.02, generator)
        elif isinstance(m, Scale):
            m.scale.fill_(1.0)
        elif isinstance(m, DictionaryCrossAttention):
            m.scale.fill_(1.0)
        elif isinstance(m, EntropyBottleneck):
            m.reset_parameters(generator)
        elif isinstance(m, GDN):
            m.reset_parameters()


def build_model(cfg, omit: Sequence[str] = ()) -> "ChannelARModel":
    """The model of a configuration: TCM for a TCMConfig, DCAE for a
    DCAEConfig."""
    from dcae_tpu_torch.config import TCMConfig
    from dcae_tpu_torch.models.dcae import DCAE
    from dcae_tpu_torch.models.tcm import TCM

    return (TCM if isinstance(cfg, TCMConfig) else DCAE)(cfg, omit=omit)


class ChannelARModel(nn.Module):
    """The shared part of DCAE and TCM (module docstring)."""

    def __init__(self, cfg, omit: Sequence[str] = ()):
        """omit: transforms among g_a, h_a, g_s that this model does not
        build (a split deployment's half): they hold no parameters, are
        not in the state dict, and raise when called. A subclass builds
        the others with `_build_halves` and ends with `_build_bottleneck`,
        in its published module order."""
        super().__init__()
        bad = set(omit) - set(HALF_TRANSFORMS)
        if bad:
            raise ValueError(f"only {HALF_TRANSFORMS} can be omitted, not "
                             f"{sorted(bad)}")
        self.cfg = cfg
        self.omitted = tuple(n for n in HALF_TRANSFORMS if n in omit)

    def _build_halves(self, build: dict) -> None:
        """g_a, g_s, h_a from {name: factory(cfg)}, those omitted held by
        a MissingTransform."""
        for name in ("g_a", "g_s", "h_a"):
            setattr(self, name, MissingTransform(name)
                    if name in self.omitted else build[name](self.cfg))

    def _build_bottleneck(self) -> None:
        cfg = self.cfg
        self.entropy_bottleneck = EntropyBottleneck(
            cfg.eb_channels, cfg.eb_filters, cfg.eb_init_scale,
            cfg.eb_tail_mass)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the published initializers: torch's layer
        defaults, trunc-normal(0.02) relative-position tables, unit scales,
        GDN's identity, the bottleneck's own init."""
        reset_modules(self, generator)

    def set_transform_dtype(self, dtype: torch.dtype) -> "ChannelARModel":
        """Run (and store) the one-sided transforms g_a, h_a, g_s in dtype."""
        for m in (self.g_a, self.h_a, self.g_s):
            m.to(dtype)
        return self

    # ------------------------------------------------------------ pieces --

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """g_a alone: the latent y in f32."""
        return self._run(self.g_a, x)

    @staticmethod
    def _run(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A transform in its own parameter dtype; the result in f32.
        Inside spatial.bands (an sp step), g_a and g_s run on this rank's
        row band and their outputs are gathered."""
        # a MissingTransform has no parameters, and raises when called
        dtype = next(module.parameters(), x).dtype
        mesh = spatial.active()
        if mesh is not None and isinstance(module, (GAnalysis, GSynthesis)):
            return spatial.run_split(module, x.to(dtype), mesh,
                                     torch.float32)
        return module(x.to(dtype)).to(torch.float32)

    def synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        """g_s alone: the reconstruction in f32."""
        return self._run(self.g_s, y_hat)

    def hyper_analysis(self, y: torch.Tensor) -> torch.Tensor:
        """h_a alone: the hyper latent z in f32."""
        return self._run(self.h_a, y)

    def hyper_synthesis(self, z_hat: torch.Tensor):
        """(latent_scales, latent_means) from z_hat, f32."""
        raise NotImplementedError

    def _slice_context(self, i: int, latent_scales, latent_means,
                       y_hat_slices: List[torch.Tensor], y_h: int, y_w: int,
                       drift: Optional[torch.Generator] = None):
        """(support, mu, sigma) of slice i from the hyper prior and the
        decoded slices before it; mu and sigma cropped to y_h x y_w.
        `drift`: the generator of the drift injection (training only)."""
        raise NotImplementedError

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()

    def _drift(self, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """x + U(-drift_noise, drift_noise): the training-time drift
        injection. Off without a generator (eval, or a caller that asks
        for none) and unless cfg.drift_noise > 0."""
        if generator is None or self.cfg.drift_noise <= 0:
            return x
        noise = draw_noise(x.shape, generator, x.dtype, x.device) - 0.5
        return x + noise * (2 * self.cfg.drift_noise)

    def _slice_lrp(self, i: int, support, y_hat_slice) -> torch.Tensor:
        lrp_in = torch.cat([support, y_hat_slice], dim=-1)
        return 0.5 * torch.tanh(self.lrp_transforms[i](lrp_in))

    # ---------------------------------------- training / eval forward --

    @staticmethod
    def _training_generator(training: bool, generator):
        if training and generator is None:
            raise ValueError("training=True requires a generator")
        return generator if training else None

    def encode_half(self, x: torch.Tensor, training: bool = False,
                    generator: Optional[torch.Generator] = None):
        """(y, z_hat, z_likelihoods): g_a, h_a, entropy bottleneck. In
        training the likelihood sees noise-quantized z and z_hat gets the
        transfer drift."""
        gen = self._training_generator(training, generator)
        y = self._run(self.g_a, x)
        z = self._run(self.h_a, y)
        _, z_likelihoods = self.entropy_bottleneck(z, training=training,
                                                   generator=gen)
        medians = self.eb_medians().reshape(1, 1, 1, -1)
        z_hat = self._drift(ste_round(z - medians) + medians, gen)
        return y, z_hat, z_likelihoods

    def decode_half(self, y: torch.Tensor, z_hat: torch.Tensor,
                    training: bool = False,
                    generator: Optional[torch.Generator] = None):
        """(x_hat, y_likelihoods, means, scales, y_hat) from raw y and the
        quantized z_hat."""
        cfg = self.cfg
        gen = self._training_generator(training, generator)
        _, y_h, y_w, _ = y.shape
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        y_hat_slices: List[torch.Tensor] = []
        likes, mus, sigmas = [], [], []
        for i, y_slice in enumerate(y.split(cfg.slice_dim, dim=-1)):
            support, mu, sigma = self._slice_context(
                i, latent_scales, latent_means, y_hat_slices, y_h, y_w,
                drift=gen)
            mus.append(mu)
            sigmas.append(sigma)
            _, like = gaussian.apply(y_slice, sigma, mu, cfg.scales_min,
                                     training=training, generator=gen)
            likes.append(like)
            y_hat_slice = ste_round(y_slice - mu) + mu
            y_hat_slice = y_hat_slice + self._slice_lrp(i, support,
                                                        y_hat_slice)
            y_hat_slices.append(y_hat_slice)
        y_hat = torch.cat(y_hat_slices, dim=-1)
        x_hat = self._run(self.g_s, y_hat)
        return (x_hat, torch.cat(likes, dim=-1), torch.cat(mus, dim=-1),
                torch.cat(sigmas, dim=-1), y_hat)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        y, z_hat, z_likelihoods = self.encode_half(x, training, generator)
        x_hat, y_likelihoods, means, scales, y_hat = self.decode_half(
            y, z_hat, training, generator)
        return {
            "x_hat": x_hat,
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
            "para": {"means": means, "scales": scales, "y": y,
                     "y_hat": y_hat, "z_hat": z_hat},
        }

    def decode_from_quantized(self, y_hat: torch.Tensor,
                              z_hat: torch.Tensor) -> torch.Tensor:
        """The decoder half on an ALREADY quantized latent: no rounding
        again; each received slice gets its LRP correction and feeds the
        next slice's context. The second and third decoder passes of the
        precision-regularization penalty (train/step.py)."""
        _, y_h, y_w, _ = y_hat.shape
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        out_slices: List[torch.Tensor] = []
        for i, y_slice in enumerate(y_hat.to(torch.float32).split(
                self.cfg.slice_dim, dim=-1)):
            support, _, _ = self._slice_context(
                i, latent_scales, latent_means, out_slices, y_h, y_w)
            out_slices.append(y_slice + self._slice_lrp(i, support, y_slice))
        return self._run(self.g_s, torch.cat(out_slices, dim=-1))

    # ------------------------------------------------ real-codec pieces --

    def encode_analysis(self, x: torch.Tensor):
        """Encoder front half of every compress mode: (y, z_symbols,
        z_hat)."""
        y = self.analysis(x)
        z = self._run(self.h_a, y)
        medians = self.eb_medians().reshape(1, 1, 1, -1)
        z_symbols = torch.round(z - medians).to(torch.int32)
        z_hat = z_symbols.to(torch.float32) + medians
        return y, z_symbols, z_hat

    def encode_rest(self, y: torch.Tensor, z_hat: torch.Tensor,
                    scale_table) -> dict:
        """Everything after the analysis transforms in one call: hyper
        synthesis, every slice context, the symbols round(y_i - mu_i) and
        the coding indexes. Each context is built by the very functions
        the decoder runs (_ctx_and_indexes, _apply_symbols), so mu, sigma
        and the indexes are computed by the same kernels at the same
        shapes as in decode_start / decode_step.

        Returns {"y_symbols": int32, "y_indexes": uint8}, each
        (S, B, yh, yw, slice_dim)."""
        y = y.to(torch.float32)
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        y_hat = latent_scales[..., :0]
        syms, idxs = [], []
        for i, y_slice in enumerate(y.split(self.cfg.slice_dim, dim=-1)):
            support, mu, indexes = self._ctx_and_indexes(
                i, latent_scales, latent_means, y_hat, scale_table)
            symbols = torch.round(y_slice - mu).to(torch.int32)
            syms.append(symbols)
            idxs.append(indexes.to(torch.uint8))
            y_hat = torch.cat(
                [y_hat, self._apply_symbols(i, support, mu, symbols)], dim=-1)
        return {"y_symbols": torch.stack(syms),
                "y_indexes": torch.stack(idxs)}

    def encode_arrays(self, x: torch.Tensor, scale_table) -> dict:
        """The whole device side of an encode in one call: encode_rest's
        arrays plus "z_symbols" (B, zh, zw, C) int32."""
        y, z_symbols, z_hat = self.encode_analysis(x)
        out = self.encode_rest(y, z_hat, scale_table)
        out["z_symbols"] = z_symbols
        return out

    def _ctx_and_indexes(self, i: int, latent_scales, latent_means,
                         y_hat_prev: torch.Tensor, scale_table):
        prev = list(y_hat_prev.split(self.cfg.slice_dim, dim=-1)) if i else []
        y_h, y_w = latent_scales.shape[1], latent_scales.shape[2]
        support, mu, sigma = self._slice_context(
            i, latent_scales, latent_means, prev, y_h, y_w)
        indexes = gaussian.build_indexes(sigma, scale_table,
                                         self.cfg.scales_min)
        return support, mu, indexes

    def _apply_symbols(self, i: int, support, mu, symbols) -> torch.Tensor:
        y_hat_slice = symbols.to(torch.float32) + mu
        return y_hat_slice + self._slice_lrp(i, support, y_hat_slice)

    def decode_start(self, z_hat: torch.Tensor, scale_table):
        """Hyper synthesis + slice-0 context: (ls, lm, support0, mu0,
        indexes0)."""
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        empty = latent_scales[..., :0]
        support, mu, indexes = self._ctx_and_indexes(
            0, latent_scales, latent_means, empty, scale_table)
        return latent_scales, latent_means, support, mu, indexes

    def decode_step(self, i: int, latent_scales, latent_means, y_hat_prev,
                    support_prev, mu_prev, symbols_prev, scale_table):
        """Finish slice i-1 with its decoded symbols, then build slice i's
        context: (y_hat, support, mu, indexes)."""
        y_hat_slice = self._apply_symbols(i - 1, support_prev, mu_prev,
                                          symbols_prev)
        y_hat = torch.cat([y_hat_prev, y_hat_slice], dim=-1)
        support, mu, indexes = self._ctx_and_indexes(
            i, latent_scales, latent_means, y_hat, scale_table)
        return y_hat, support, mu, indexes

    def decode_end(self, y_hat_prev, support_last, mu_last, symbols_last
                   ) -> torch.Tensor:
        """Apply the last slice and synthesize the image, clipped to
        [0, 1]."""
        y_hat_slice = self._apply_symbols(self.cfg.num_slices - 1,
                                          support_last, mu_last,
                                          symbols_last)
        y_hat = torch.cat([y_hat_prev, y_hat_slice], dim=-1)
        return self.decode_synthesis(y_hat)

    def decode_synthesis(self, y_hat: torch.Tensor) -> torch.Tensor:
        """g_s, clipped to [0, 1]."""
        return torch.clamp(self._run(self.g_s, y_hat), 0.0, 1.0)

    def decode_device_streams(self, z_hat: torch.Tensor, words, n_words,
                              states, patch_pos, patch_val, override: bool,
                              true_y, lut_sym, lut_sf, scale_table,
                              chained: bool = False):
        """Slice contexts + entropy decode of the K-lane interleaved rANS
        streams ON THE DEVICE (entropy/device_decode.py): the channel-AR
        chain makes no round trip to the host and never waits for the
        device. Synthesis is NOT in this function (decode_synthesis comes
        right after): the certified ENCODE replays this very function and
        must not pay for g_s.

        words: (S, W) uint16 bits, per-slice streams (padded); n_words:
        (S,) int32 true word counts; states: (S, K) uint32 bits decode-start
        lane states, or (K,) when chained; patch_pos / patch_val: (S, P)
        int32 escape patches (entropy/device_decode.py
        encode_slices_with_patches): true symbol values scattered over the
        clamped stream symbols right after entropy decode; rows whose
        position is out of range are dropped.

        override / true_y (bool / (B, yh, yw, M) f32) exist for the
        ENCODER: the sigma -> index chain is only bit-stable when the same
        functions run at the same shapes with the same kernels, so the
        encoder teacher-forces THIS function with the raw latent y
        (override=True: each slice's symbols are round(y_i - mu_i), and the
        y_hat chain reads them; no stream is decoded and no decode kernel
        is launched), then encodes the streams under the (indexes, symbols)
        returned here. The real decode (override=False) then reproduces
        those indexes as long as the decoded symbols equal the returned
        ones, which holds slice by slice by induction. Decoders pass
        override=False and true_y=None.

        chained=True: `states` is ONE (K,) vector spanning all slices;
        slice i starts from slice i-1's final states, and the base-state
        checksum applies once, after the last slice.

        Returns (y_hat, ok, idxs, syms): ok is a () bool tensor on the
        device, the all-slices checksum (every stream consumed exactly and
        every lane back at 2^16); idxs (S, B, yh, yw, sd) int8 and syms
        (same, int32) are the per-slice chains the certified encoder
        codes.

        On the card, with no gradient wanted, the pass is captured once a
        (direction, shape) key as a CUDA graph and replayed, its outputs
        copied out of the graph (models/entropy_graph.py); elsewhere it
        runs eagerly, bitwise alike."""
        a = dict(z_hat=z_hat, words=words, n_words=n_words, states=states,
                 patch_pos=patch_pos, patch_val=patch_val, override=override,
                 true_y=true_y, lut_sym=lut_sym, lut_sf=lut_sf,
                 scale_table=scale_table, chained=chained)
        if not z_hat.is_cuda:
            return self._entropy_pass(**a)
        graphs = self.__dict__.get("_entropy_graphs")
        if graphs is None:
            graphs = self._entropy_graphs = entropy_graph.PassGraphs()
        return graphs.run(self, a)

    def _entropy_pass(self, z_hat: torch.Tensor, words, n_words, states,
                      patch_pos, patch_val, override: bool, true_y, lut_sym,
                      lut_sf, scale_table, chained: bool = False):
        """decode_device_streams run eagerly."""
        from dcae_tpu_torch.entropy.device_decode import (
            RANS_L16, decode_interleaved, decode_interleaved_chain)
        from dcae_tpu_torch.ops.kernels.rans_lanes import bool_all, u32_bits

        cfg = self.cfg
        sd = cfg.slice_dim
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        dev = z_hat.device
        y_hat = latent_scales[..., :0]
        ok = torch.ones((), dtype=torch.bool, device=dev)
        if not override:
            states = u32_bits(states, dev)
            K = states.shape[-1]
        chain_states = states if chained else None      # (K,), threaded
        idx_list, sym_list = [], []
        for i in range(cfg.num_slices):
            support, mu, indexes = self._ctx_and_indexes(
                i, latent_scales, latent_means, y_hat, scale_table)
            idx_list.append(indexes.to(torch.int8))
            if override:
                y_slice = true_y[..., i * sd:(i + 1) * sd].to(torch.float32)
                sym = torch.round(y_slice - mu).to(torch.int32)
            else:
                n_i = indexes.numel()
                if chained:
                    flat, ok_i, chain_states = decode_interleaved_chain(
                        words[i], n_words[i], chain_states,
                        indexes.reshape(-1), lut_sym, lut_sf, K)
                else:
                    flat, ok_i = decode_interleaved(
                        words[i], n_words[i], states[i],
                        indexes.reshape(-1), lut_sym, lut_sf, K)
                ok = ok & ok_i
                # scatter the patches; a position outside [0, n) lands in a
                # spare slot that is cut off
                pos = patch_pos[i].to(torch.int64)
                pos = torch.where((pos >= 0) & (pos < n_i), pos,
                                  torch.full_like(pos, n_i))
                flat = torch.cat([flat, flat.new_zeros(1)]).scatter_(
                    0, pos, patch_val[i].to(torch.int32))[:n_i]
                sym = flat.reshape(indexes.shape)
            sym_list.append(sym)
            y_hat = torch.cat(
                [y_hat, self._apply_symbols(i, support, mu, sym)], dim=-1)
        if chained and not override:
            # the checksum sits at the end of the chain: every lane must be
            # back at the 2^16 base after the LAST slice
            ok = ok & bool_all(chain_states == RANS_L16)
        return y_hat, ok, torch.stack(idx_list), torch.stack(sym_list)

    def decode_all(self, z_hat: torch.Tensor, symbols: torch.Tensor
                   ) -> torch.Tensor:
        """The whole decode in one call when every slice's symbols are
        known (the encoder shipped its coding indexes, so the host decoded
        all slices first): each slice's context and LRP, then synthesis.
        symbols: (B, yh, yw, M) int. No index is recomputed, so nothing
        here has to agree bitwise with the encoder."""
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        y_h, y_w = latent_scales.shape[1], latent_scales.shape[2]
        y_hat_slices: List[torch.Tensor] = []
        for i, sym in enumerate(symbols.split(self.cfg.slice_dim, dim=-1)):
            support, mu, _ = self._slice_context(
                i, latent_scales, latent_means, y_hat_slices, y_h, y_w)
            y_hat_slices.append(self._apply_symbols(i, support, mu, sym))
        return self.decode_synthesis(torch.cat(y_hat_slices, dim=-1))

    def latent_decompress(self, y: torch.Tensor) -> torch.Tensor:
        """Latent hand-off decode: the payload is the raw latent y; z is
        derived again here and each slice is quantized against its own
        context."""
        y = y.to(torch.float32)
        z = self._run(self.h_a, y)
        medians = self.eb_medians().reshape(1, 1, 1, -1)
        z_hat = torch.round(z - medians) + medians
        latent_scales, latent_means = self.hyper_synthesis(z_hat)
        y_h, y_w = y.shape[1], y.shape[2]
        y_hat_slices: List[torch.Tensor] = []
        for i, y_slice in enumerate(y.split(self.cfg.slice_dim, dim=-1)):
            support, mu, _ = self._slice_context(
                i, latent_scales, latent_means, y_hat_slices, y_h, y_w)
            y_hat_slice = torch.round(y_slice - mu) + mu
            y_hat_slices.append(y_hat_slice + self._slice_lrp(
                i, support, y_hat_slice))
        return self.decode_synthesis(torch.cat(y_hat_slices, dim=-1))
