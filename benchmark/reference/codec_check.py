"""The judge of the codec cells: the plain reference against what the
program's timed path produced (its streams, its decoded latent, its
coding indexes and its reconstruction), request by request.

What the reference works out again from the images and the weights, in
f32 with TF32 off, image by image:

  z_gap              how far past the rounding boundary the program's z
                     symbols lie, at worst: max(|z_sym - (z - median)| -
                     0.5, 0) with the reference's z, decoded from the
                     program's z streams by the reference's own classic
                     decoder and tables, over the image's largest |z -
                     median|; 0 where every symbol agrees or flipped
                     within rounding: the analysis and hyper transforms
                     and the z stream.
  z_symbols_differ   share of the z symbols of all the sample's images,
                     decoded from the program's z streams by the
                     reference's own classic decoder and tables, that
                     differ from round(h_a(g_a(x)) - median): the analysis
                     and hyper transforms and the z stream.
  y_symbols_differ   share of the program's decoded y symbols that differ
                     from round(y - mu) with the reference's y and mu:
                     the analysis transform and the quantisation.
  indexes_differ     share of the coding indexes the program decoded
                     under that differ from the reference's: the entropy
                     model's scales.
  y_hat_gap          the largest gap between the program's y_hat and
                     symbols + mu + LRP of the reference, over the
                     largest |y_hat|: the means and the LRP.
  lane_errors        symbols where the reference's own lane decoder,
                     reading the program's streams, states and patches,
                     differs from the program's decode, plus slices whose
                     words are not all read, plus lanes not back at the
                     base state: the lane coders' bytes, exactly.
  x_hat_gap          the largest gap between the program's x_hat and
                     clamp(g_s(y_hat)) of the reference: the synthesis.

The entropy model and the lane decode follow the program's own state: the
reference builds each slice's context from the program's z_hat and its
earlier slices' y_hat, and decodes the lanes under the program's indexes.
An independent f32 chain cannot reproduce the indexes bit for bit (a
scale within rounding of a table step picks the neighbouring row, and one
such row desynchronises the shared word stream), so the indexes are
judged on their own by `indexes_differ`, and the chain's start (z) and
its inputs (y) by their own numbers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import entropy as E
from reference import model as ref


class Tables:
    """The reference's coding tables, worked out from the weights."""

    def __init__(self, c: dict, state: Dict[str, torch.Tensor]):
        pre = "entropy_bottleneck."
        eb = {k[len(pre):]: v.detach().cpu().numpy()
              for k, v in state.items() if k.startswith(pre)}
        self.scale_table = ref.scale_table(c)
        self.gauss = E.gaussian_table(self.scale_table, c["gc_tail_mass"])
        self.lut = self.gauss.lut()
        self.fact = E.factorized_table(eb)
        self.medians = np.asarray(eb["quantiles"], np.float32)[:, 0, 1]


def _share(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.count_nonzero(a != b)) / max(a.size, 1)


@torch.no_grad()
def judge(c: dict, state: Dict[str, torch.Tensor], samples: List[dict],
          device) -> Dict[str, float]:
    """samples: one dict a request: "x" (B, H, W, 3) uint8, "enc" (the
    program's compress_device result), "y_hat" (B, yh, yw, M), "idxs" and
    "syms" (S, B, yh, yw, sd), "x_hat" (B, H, W, 3), all on the host.
    Returns the numbers of the module docstring (the worst image or
    request; z_symbols_differ over all the sample's z symbols; all
    infinite when a request left images unanswered), "index0_share" (the
    share of the reference's indexes at the scale bound's row) and
    "requests" / "images" judged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = ref.DCAE(c)
    m.load_state_dict(state, strict=True)
    m = m.to(device).eval()
    t = Tables(c, state)
    st = torch.as_tensor(t.scale_table, device=device)
    med = torch.as_tensor(t.medians, device=device)
    S, sd = c["num_slices"], m.slice_dim
    worst = {"z_gap": 0.0, "z_symbols_differ": 0.0, "y_symbols_differ": 0.0,
             "indexes_differ": 0.0, "y_hat_gap": 0.0, "lane_errors": 0.0,
             "x_hat_gap": 0.0}
    n_img = idx0 = n_idx = z_diff = z_all = unanswered = 0

    def up(name, v):
        worst[name] = max(worst[name], float(v))

    for smp in samples:
        enc = smp["enc"]
        B = smp["x"].shape[0]
        answered = {len(enc["z_strings"]), smp["x_hat"].shape[0],
                    smp["y_hat"].shape[0], smp["syms"].shape[1]}
        if answered != {B}:          # images of the request left unanswered
            unanswered += 1
            continue
        zh, zw = enc["shape"]
        C = c["eb_channels"]
        z_index = np.repeat(np.arange(C, dtype=np.int64), zh * zw)
        y_hat_p = torch.as_tensor(smp["y_hat"])
        idx_p = np.asarray(smp["idxs"]).astype(np.int64)
        sym_p = np.asarray(smp["syms"]).astype(np.int64)
        # the lane streams: the reference's decoder under the program's
        # indexes, the patches restored; one K-lane state set a chain
        errors = 0
        chained = bool(enc.get("chained", True))
        states = np.asarray(enc["states"]).astype(np.int64)
        x = states if chained else None
        for s in range(S):
            words = np.frombuffer(enc["istreams"][s], np.uint16)
            x0 = x if chained else states[s]
            try:
                dec, x, ptr = E.decode_lanes(words, x0, idx_p[s].reshape(-1),
                                             t.gauss, t.lut)
            except ValueError:          # the words ran out: all wrong
                errors += idx_p[s].size
                continue
            pos, val = enc["patches"][s]
            dec[np.asarray(pos, np.int64)] = np.asarray(val, np.int64)
            errors += int(np.count_nonzero(dec != sym_p[s].reshape(-1)))
            errors += int(ptr != len(words))
            if not chained:
                errors += int(np.count_nonzero(x != E.RANS_L16))
        if chained:
            errors += int(np.count_nonzero(x != E.RANS_L16))
        up("lane_errors", errors)
        for b in range(B):
            xb = torch.as_tensor(smp["x"][b:b + 1], device=device)
            xb = xb.to(torch.float32) / 255.0
            y = m.g_a(xb)
            z = m.h_a(y)
            zc = (z - med).cpu().numpy().astype(np.float64)
            z_p = E.decode_classic(enc["z_strings"][b], z_index, t.fact)
            z_p = z_p.reshape(C, zh, zw).transpose(1, 2, 0)[None]
            z_diff += int(np.count_nonzero(z_p != np.round(zc)))
            z_all += z_p.size
            past = np.maximum(np.abs(z_p - zc) - 0.5, 0.0).max()
            up("z_gap", past / max(float(np.abs(zc).max()), 1e-30))
            z_hat = torch.as_tensor(z_p, device=device).to(torch.float32) \
                + med
            ls, lm = m.hyper_prior(z_hat)
            yh_p = y_hat_p[b:b + 1].to(device)
            prev, gap, scale = [], 0.0, 0.0
            for i in range(S):
                support, mu, sigma = m.slice_context(i, ls, lm, prev)
                idx_r = ref.scale_indexes(sigma, st).cpu().numpy()
                up("indexes_differ", _share(idx_p[i, b:b + 1], idx_r))
                idx0 += int(np.count_nonzero(idx_r == 0))
                n_idx += idx_r.size
                ys = y[..., i * sd:(i + 1) * sd]
                sym_r = torch.round(ys - mu).to(torch.int64).cpu().numpy()
                up("y_symbols_differ", _share(sym_p[i, b:b + 1], sym_r))
                q = torch.as_tensor(sym_p[i, b:b + 1], device=device).to(
                    torch.float32) + mu
                yh_r = q + m.lrp(i, support, q)
                part = yh_p[..., i * sd:(i + 1) * sd]
                gap = max(gap, float((part - yh_r).abs().max()))
                scale = max(scale, float(yh_r.abs().max()))
                prev.append(part)
            up("y_hat_gap", gap / max(scale, 1e-30))
            xh_r = torch.clamp(m.g_s(yh_p), 0.0, 1.0)
            xh_p = torch.as_tensor(smp["x_hat"][b:b + 1], device=device)
            up("x_hat_gap", float((xh_p.to(torch.float32) - xh_r).abs()
                                  .max()))
            n_img += 1
    if z_all:
        worst["z_symbols_differ"] = z_diff / z_all
    if unanswered:
        worst = {k: float("inf") for k in worst}
    worst["index0_share"] = idx0 / max(n_idx, 1)
    worst["requests"] = len(samples)
    worst["images"] = n_img
    return worst
