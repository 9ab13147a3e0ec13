"""The whole request's or step's share of the card's peak: the model's
FLOPs, counted by FlopCounterMode over the plain reference at the cell's
shapes (training: 3x the forward, recompute not counted), each part at
the peak of its input dtype, over the time a request or step takes
untraced, in the same run (a data-parallel step: one card's share of it
against one card's peak)."""

from harness import readers, yardstick


def read(v, name):
    t = readers.request_s(v)
    if not t:
        return None
    w = readers.work(v)
    B, H, W = readers.shapes(v)
    fl = yardstick.model_flops(readers.model_config(v), B, H, W)
    td = v.cell.config["dtypes"]["transforms"]
    parts = [(fl["g_a"] + fl["h_a"] + fl["g_s"], td),
             (int(w["entropy_passes"]) * fl["entropy"], "float32")]
    factor = float(w.get("flop_factor", 1))
    least = sum(factor * f / yardstick.PEAK_FLOPS[d] for f, d in parts)
    return 100.0 * least / t
