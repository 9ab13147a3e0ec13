"""Share of its least time that TCM's window-8 attention half-blocks take
on the device: their work counted from the shapes
(tcm_yardstick.window_launches: g_a and g_s in the transforms' dtype,
SWAtten's in f32) over the device time of the wmsa kernels; None where
none ran."""

from harness import readers, tcm_yardstick, yardstick


def read(v, name):
    n = readers.per_request(v)
    t = readers.region_s(v, "wmsa_kernel") if n else None
    if t is None:
        return None
    w = readers.work(v)
    B, H, W = readers.shapes(v)
    launches = tcm_yardstick.window_launches(
        readers.model_config(v), B, H, W,
        v.cell.config["dtypes"]["transforms"], int(w["entropy_passes"]))
    least = sum(yardstick.least_time(f, b, d) for f, b, d in launches)
    return 100.0 * least * n / t
