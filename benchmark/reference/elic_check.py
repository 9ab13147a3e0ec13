"""The judge of the ELIC codec cells: reference/codec_check.py's checks,
each with its definition there, on ELIC's coding steps.

ELIC codes its latent in 10 steps, the anchors and then the non-anchors
of each of its five channel groups (reference/elic_model.py). A step's
symbols and indexes are its positions only, (B, yh, yw / 2, group): each
row keeps, in order, the columns whose row + column parity is the
step's. The program hands the judge the steps' arrays flattened one
after another; the judge cuts them by these shapes and picks the
reference's values at the same positions with its own checkerboard mask.

The entropy model follows the program's own state, as codec_check's
does: each step's parameters come from the program's z_hat, the
program's decoded earlier groups and, for the non-anchors, the
program's decoded anchors of the group. ELIC has no LRP, so y_hat_gap
holds the program's y_hat against symbols + mu of the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import codec_check, elic_model
from reference import entropy as E
from reference import model as ref


def step_shapes(groups, B: int, yh: int, yw: int) -> List[tuple]:
    """The shape of each step's symbols, in coding order."""
    return [(B, yh, yw // 2, g) for g in groups for _ in range(2)]


def cut(flat: np.ndarray, shapes: List[tuple]) -> List[np.ndarray]:
    """The steps' arrays from their flattens laid end to end."""
    ends = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    return [p.reshape(s) for p, s in zip(np.split(flat, ends), shapes)]


def _at(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The positions of `mask` (yh, yw) of NHWC t, row by row:
    (B, yh, yw / 2, C)."""
    B, H, W, C = t.shape
    return t[:, mask].reshape(B, H, W // 2, C)


@torch.no_grad()
def judge(c: dict, state: Dict[str, torch.Tensor], samples: List[dict],
          device) -> Dict[str, float]:
    """samples: one dict a request: "x" (B, H, W, 3) uint8, "enc" (the
    program's compress_device result), "y_hat" (B, yh, yw, M), "idxs" and
    "syms" (the steps' arrays flattened end to end), "x_hat" (B, H, W,
    3), all on the host. Returns codec_check.judge's numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = elic_model.ELIC(c)
    m.load_state_dict(state, strict=True)
    m = m.to(device).eval()
    t = codec_check.Tables(c, state)
    st = torch.as_tensor(t.scale_table, device=device)
    med = torch.as_tensor(t.medians, device=device)
    G = list(c["groups"])
    worst = {"z_gap": 0.0, "z_symbols_differ": 0.0, "y_symbols_differ": 0.0,
             "indexes_differ": 0.0, "y_hat_gap": 0.0, "lane_errors": 0.0,
             "x_hat_gap": 0.0}
    n_img = idx0 = n_idx = z_diff = z_all = unanswered = 0

    def up(name, v):
        worst[name] = max(worst[name], float(v))

    share = codec_check._share
    for smp in samples:
        enc = smp["enc"]
        B = smp["x"].shape[0]
        y_hat_p = torch.as_tensor(smp["y_hat"])
        _, yh, yw, _ = y_hat_p.shape
        shapes = step_shapes(G, B, yh, yw)
        answered = {len(enc["z_strings"]), smp["x_hat"].shape[0],
                    y_hat_p.shape[0]}
        if answered != {B} or np.asarray(smp["syms"]).size != sum(
                int(np.prod(s)) for s in shapes):
            unanswered += 1
            continue
        zh, zw = enc["shape"]
        C = c["eb_channels"]
        z_index = np.repeat(np.arange(C, dtype=np.int64), zh * zw)
        idx_p = cut(np.asarray(smp["idxs"]).astype(np.int64), shapes)
        sym_p = cut(np.asarray(smp["syms"]).astype(np.int64), shapes)
        # the lane streams: the reference's decoder under the program's
        # indexes, the patches restored; one K-lane state set a chain
        errors = 0
        chained = bool(enc.get("chained", True))
        states = np.asarray(enc["states"]).astype(np.int64)
        x = states if chained else None
        for s in range(len(shapes)):
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
        anchor = elic_model.anchor_mask(yh, yw, device)
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
            side = m.hyper_prior(z_hat)
            yh_p = y_hat_p[b:b + 1].to(device)
            prev, gap, scale, c0 = [], 0.0, 0.0, 0
            for k, g in enumerate(G):
                part = yh_p[..., c0:c0 + g]
                ctx = m.group_context(k, side, prev)
                anchors = torch.where(anchor[None, :, :, None], part, 0.0)
                for parity, sp in ((0, None), (1, anchors)):
                    i = 2 * k + parity
                    mask = anchor if parity == 0 else ~anchor
                    sigma, mu = m.group_params(k, ctx, sp)
                    sigma, mu = _at(sigma, mask), _at(mu, mask)
                    idx_r = ref.scale_indexes(sigma, st).cpu().numpy()
                    up("indexes_differ", share(idx_p[i][b:b + 1], idx_r))
                    idx0 += int(np.count_nonzero(idx_r == 0))
                    n_idx += idx_r.size
                    ys = _at(y[..., c0:c0 + g], mask)
                    sym_r = torch.round(ys - mu).to(torch.int64)
                    sym_r = sym_r.cpu().numpy()
                    up("y_symbols_differ", share(sym_p[i][b:b + 1], sym_r))
                    yh_r = torch.as_tensor(sym_p[i][b:b + 1], device=device
                                           ).to(torch.float32) + mu
                    gap = max(gap, float((_at(part, mask) - yh_r).abs()
                                         .max()))
                    scale = max(scale, float(yh_r.abs().max()))
                prev.append(part)
                c0 += g
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
