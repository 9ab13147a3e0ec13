"""Host-side integer CDF tables ("update()" / table baking), in numpy.

Coding tables are pure functions of the entropy-model parameters, built
once on the host with exact integer quantization (native
pmf_to_quantized_cdf). Encoder and decoder share these integer tables, so
float drift between them cannot desynchronize the bitstream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.special import erfc, ndtri

from dcae_tpu_torch.entropy import rans
from dcae_tpu_torch.entropy.gaussian import get_scale_table

PRECISION = 16


@dataclasses.dataclass
class CdfTable:
    """A bank of quantized CDF rows + the metadata the range coder needs."""
    quantized_cdf: np.ndarray  # int32 [rows, max_len+2]
    cdf_length: np.ndarray     # int32 [rows]  (pmf_length + 2)
    offset: np.ndarray         # int32 [rows]
    _lut: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def lut(self) -> np.ndarray:
        """Fused (symbol|start|freq) decode LUT (uint64 [rows, 2^16]),
        built lazily once per bake."""
        if self._lut is None:
            self._lut = rans.build_decode_lut(self.quantized_cdf,
                                              self.cdf_length)
        return self._lut

    def as_dict(self, prefix: str) -> dict:
        return {
            f"{prefix}quantized_cdf": self.quantized_cdf,
            f"{prefix}cdf_length": self.cdf_length,
            f"{prefix}offset": self.offset,
        }

    @classmethod
    def from_dict(cls, d: dict, prefix: str) -> "CdfTable":
        return cls(
            quantized_cdf=np.asarray(d[f"{prefix}quantized_cdf"], np.int32),
            cdf_length=np.asarray(d[f"{prefix}cdf_length"], np.int32),
            offset=np.asarray(d[f"{prefix}offset"], np.int32),
        )


@dataclasses.dataclass
class CodecTables:
    """Everything the host coder needs: the Gaussian scale-indexed bank, the
    factorized (per-channel) bank, its medians, and the scale table."""
    gaussian: CdfTable
    factorized: CdfTable
    medians: np.ndarray      # float32 [C]: z quantization offsets
    scale_table: np.ndarray  # float32 [levels]

    def as_dict(self) -> dict:
        d = {}
        d.update(self.gaussian.as_dict("gaussian_"))
        d.update(self.factorized.as_dict("factorized_"))
        d["medians"] = self.medians
        d["scale_table"] = self.scale_table
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CodecTables":
        return cls(
            gaussian=CdfTable.from_dict(d, "gaussian_"),
            factorized=CdfTable.from_dict(d, "factorized_"),
            medians=np.asarray(d["medians"], np.float32),
            scale_table=np.asarray(d["scale_table"], np.float32),
        )

    def save(self, path: str) -> None:
        """One .npz, in the JAX package's key names: either package loads
        the other's file."""
        np.savez(path, **self.as_dict())

    @classmethod
    def load(cls, path: str) -> "CodecTables":
        with np.load(path) as z:
            return cls.from_dict(dict(z))


def _standardized_cumulative(x: np.ndarray) -> np.ndarray:
    return 0.5 * erfc(-(2 ** -0.5) * x)


def _rows_to_table(pmf: np.ndarray, tail: np.ndarray,
                   pmf_length: np.ndarray, offset: np.ndarray) -> CdfTable:
    rows = pmf.shape[0]
    max_length = int(pmf_length.max())
    cdf = np.zeros((rows, max_length + 2), np.int32)
    for i in range(rows):
        L = int(pmf_length[i])
        prob = np.concatenate(
            [pmf[i, :L], [max(float(tail[i]), 0.0)]]).astype(np.float32)
        row = rans.pmf_to_quantized_cdf(prob, PRECISION)
        cdf[i, : len(row)] = row
    return CdfTable(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=offset.astype(np.int32),
    )


def build_gaussian_table(scale_table: np.ndarray | None = None,
                         tail_mass: float = 1e-9) -> CdfTable:
    """Quantized CDF bank of the scale-indexed Gaussian conditional."""
    if scale_table is None:
        scale_table = get_scale_table()
    scale_table = np.asarray(scale_table, np.float64)
    multiplier = -float(ndtri(tail_mass / 2))
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(
        np.arange(max_length, dtype=np.int64)[None, :] - pmf_center[:, None]
    ).astype(np.float32)
    s = scale_table.astype(np.float32)[:, None]
    upper = _standardized_cumulative((0.5 - samples) / s)
    lower = _standardized_cumulative((-0.5 - samples) / s)
    pmf = (upper - lower).astype(np.float32)
    tail = 2.0 * lower[:, 0]
    return _rows_to_table(pmf, tail, pmf_length, -pmf_center)


def _np_logits_cumulative(params: dict, n_filters: int,
                          inputs: np.ndarray) -> np.ndarray:
    """Numpy statement of EntropyBottleneck._logits_cumulative; inputs
    (C,1,N)."""
    logits = inputs.astype(np.float32)
    for i in range(n_filters + 1):
        matrix = np.asarray(params[f"_matrix{i}"], np.float32)
        bias = np.asarray(params[f"_bias{i}"], np.float32)
        softplus = np.logaddexp(0.0, matrix)
        logits = np.einsum("cij,cjn->cin", softplus, logits) + bias
        if i < n_filters:
            factor = np.asarray(params[f"_factor{i}"], np.float32)
            logits = logits + np.tanh(factor) * np.tanh(logits)
    return logits


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def build_factorized_table(eb_params: dict) -> CdfTable:
    """Quantized CDF bank (one row per channel) from the bottleneck's
    parameters {_matrix{i}, _bias{i}, _factor{i}, quantiles} as numpy."""
    n_filters = len([k for k in eb_params if k.startswith("_factor")])
    quantiles = np.asarray(eb_params["quantiles"], np.float32)
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]), 0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians), 0, None)
    minima = minima.astype(np.int64)
    maxima = maxima.astype(np.int64)
    pmf_length = (maxima + minima + 1).astype(np.int64)
    max_length = int(pmf_length.max())

    pmf_start = (medians - minima.astype(np.float32))  # (C,)
    samples = (np.arange(max_length, dtype=np.float32)[None, None, :]
               + pmf_start[:, None, None])  # (C,1,L)
    lower = _np_logits_cumulative(eb_params, n_filters, samples - 0.5)
    upper = _np_logits_cumulative(eb_params, n_filters, samples + 0.5)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]
    tail = _sigmoid(lower[:, 0, 0]) + _sigmoid(-upper[:, 0, -1])
    return _rows_to_table(pmf.astype(np.float32), tail, pmf_length, -minima)


def build_codec_tables(eb_params: dict,
                       scale_table: np.ndarray | None = None,
                       tail_mass: float = 1e-9) -> CodecTables:
    """Bake all tables a codec needs for real compress/decompress."""
    if scale_table is None:
        scale_table = get_scale_table()
    quantiles = np.asarray(eb_params["quantiles"], np.float32)
    return CodecTables(
        gaussian=build_gaussian_table(scale_table, tail_mass),
        factorized=build_factorized_table(eb_params),
        medians=quantiles[:, 0, 1].astype(np.float32),
        scale_table=np.asarray(scale_table, np.float32),
    )
