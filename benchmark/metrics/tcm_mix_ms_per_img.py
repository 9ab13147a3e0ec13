"""Host ms an image inside the program's `tcm.mix` spans (every
ConvTransBlock call of g_a, h_a, the two hyper synthesis nets and g_s)
over the untraced part of the traced run's window; None where the
program records no such span."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "tcm.mix")
