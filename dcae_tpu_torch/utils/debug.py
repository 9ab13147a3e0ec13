"""Diagnostics: a tensor dump / compare harness for hunting drift across
devices, the JAX package's utils/debug.py. dump_codec_run writes every
intermediate of a staged encode under <root>/<tag>/ (<name>.npy, streams
as <name>.bin, manifest.json), in the JAX package's names and layout
(NHWC), so that either package's compare_dumps diffs a dump of the other:
card against CPU, port against the JAX package, one encoder mode against
another.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch


class TensorDump:
    """Append-only store of named arrays for one run/device tag."""

    def __init__(self, root: str, tag: str):
        self.dir = os.path.join(root, tag)
        os.makedirs(self.dir, exist_ok=True)
        self._order: List[str] = []

    def add(self, name: str, value) -> None:
        arr = np.asarray(value)
        np.save(os.path.join(self.dir, f"{name}.npy"), arr)
        self._order.append(name)

    def add_bytes(self, name: str, data: bytes) -> None:
        with open(os.path.join(self.dir, f"{name}.bin"), "wb") as f:
            f.write(data)
        self._order.append(name)

    def finish(self) -> None:
        with open(os.path.join(self.dir, "manifest.json"), "w") as f:
            json.dump(self._order, f)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@torch.no_grad()
def dump_codec_run(codec, x, root: str, tag: str) -> TensorDump:
    """Run the staged encoder (the decoder's own functions, slice by
    slice), dumping y, the z symbols, z_hat, the latent scales and means,
    and each slice's mu, coding indexes and symbols; then the first
    image's y and z streams of codec.compress."""
    d = TensorDump(root, tag)
    model, st, sd = codec.model, codec._scale_table, codec.cfg.slice_dim
    x = codec._input(x)
    y, z_sym, z_hat = model.encode_analysis(x)
    d.add("y", _np(y))
    d.add("z_symbols", _np(z_sym))
    d.add("z_hat", _np(z_hat))
    ls, lm, support, mu, idx = model.decode_start(z_hat, st)
    d.add("latent_scales", _np(ls))
    d.add("latent_means", _np(lm))
    y_np = _np(y)
    y_hat = torch.zeros((*y.shape[:3], 0), device=y.device)
    symbols = None
    for i in range(codec.cfg.num_slices):
        if i > 0:
            y_hat, support, mu, idx = model.decode_step(
                i, ls, lm, y_hat, support, mu, symbols, st)
        mu_np = _np(mu)
        d.add(f"mu_{i}", mu_np)
        d.add(f"indexes_{i}", _np(idx))
        sym = np.round(y_np[..., i * sd:(i + 1) * sd] - mu_np
                       ).astype(np.int32)
        d.add(f"symbols_{i}", sym)
        symbols = torch.as_tensor(sym, device=y.device)
    enc = codec.compress(x)
    d.add_bytes("y_string", enc["strings"][0][0])
    d.add_bytes("z_string", enc["strings"][1][0])
    d.finish()
    return d


def compare_dumps(root: str, tag_a: str, tag_b: str,
                  atol: float = 0.0) -> Dict[str, dict]:
    """Diff two dump sets. Returns {name: {max_abs, max_rel, equal,
    first_mismatch}} for arrays and byte-equality for .bin payloads."""
    dir_a = os.path.join(root, tag_a)
    dir_b = os.path.join(root, tag_b)
    report: Dict[str, dict] = {}
    for fname in sorted(os.listdir(dir_a)):
        path_b = os.path.join(dir_b, fname)
        if not os.path.exists(path_b):
            report[fname] = {"missing_in": tag_b}
            continue
        if fname.endswith(".npy"):
            a = np.load(os.path.join(dir_a, fname))
            b = np.load(path_b)
            if a.shape != b.shape:
                report[fname] = {"shape_mismatch": [a.shape, b.shape]}
                continue
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            max_abs = float(diff.max()) if diff.size else 0.0
            denom = np.maximum(np.abs(a), 1e-12)
            max_rel = float((diff / denom).max()) if diff.size else 0.0
            entry = {"max_abs": max_abs, "max_rel": max_rel,
                     "equal": bool(max_abs <= atol)}
            if max_abs > atol and diff.size:
                idx = np.unravel_index(int(np.argmax(diff)), diff.shape)
                entry["first_mismatch"] = {
                    "index": [int(i) for i in idx],
                    "a": float(a[idx]), "b": float(b[idx])}
            report[fname] = entry
        elif fname.endswith(".bin"):
            with open(os.path.join(dir_a, fname), "rb") as f:
                da = f.read()
            with open(path_b, "rb") as f:
                db = f.read()
            report[fname] = {"equal": da == db,
                             "len": [len(da), len(db)]}
    return report


def print_report(report: Dict[str, dict]) -> bool:
    """Human-readable diff summary; returns True when everything matches."""
    ok = True
    for name, entry in report.items():
        if entry.get("equal"):
            print(f"  {name}: OK")
        else:
            ok = False
            print(f"  {name}: MISMATCH {entry}")
    return ok
