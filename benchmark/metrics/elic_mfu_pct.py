"""The whole ELIC request's share of the card's peak: mfu_pct's recipe
with the ELIC model's FLOPs (harness/elic_yardstick.py, FlopCounterMode
over the plain ELIC reference at the cell's shapes): g_a + h_a + g_s at
the peak of the transforms' dtype and the traffic's entropy passes at the
f32 peak, over the time a request takes untraced, in the same run."""

from harness import elic_yardstick, readers, yardstick


def read(v, name):
    t = readers.request_s(v)
    if not t:
        return None
    w = readers.work(v)
    B, H, W = readers.shapes(v)
    fl = elic_yardstick.model_flops(readers.model_config(v), B, H, W)
    td = v.cell.config["dtypes"]["transforms"]
    parts = [(fl["g_a"] + fl["h_a"] + fl["g_s"], td),
             (int(w["entropy_passes"]) * fl["entropy"], "float32")]
    factor = float(w.get("flop_factor", 1))
    least = sum(factor * f / yardstick.PEAK_FLOPS[d] for f, d in parts)
    return 100.0 * least / t
