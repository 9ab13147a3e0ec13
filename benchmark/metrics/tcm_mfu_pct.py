"""The whole TCM request's share of the card's peak: mfu_pct's recipe
with the TCM model's FLOPs (harness/tcm_yardstick.py, FlopCounterMode
over the plain TCM reference at the cell's shapes): g_a + h_a + g_s at
the peak of the transforms' dtype and the traffic's entropy passes at the
f32 peak, over the time a request takes untraced, in the same run."""

from harness import readers, tcm_yardstick, yardstick


def read(v, name):
    t = readers.request_s(v)
    if not t:
        return None
    w = readers.work(v)
    B, H, W = readers.shapes(v)
    fl = tcm_yardstick.model_flops(readers.model_config(v), B, H, W)
    td = v.cell.config["dtypes"]["transforms"]
    parts = [(fl["g_a"] + fl["h_a"] + fl["g_s"], td),
             (int(w["entropy_passes"]) * fl["entropy"], "float32")]
    factor = float(w.get("flop_factor", 1))
    least = sum(factor * f / yardstick.PEAK_FLOPS[d] for f, d in parts)
    return 100.0 * least / t
