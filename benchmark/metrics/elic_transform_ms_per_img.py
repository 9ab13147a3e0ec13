"""Host ms an image inside the program's `elic.transform` spans (every
g_a, h_a and g_s call of ELIC) over the untraced part of the traced run's
window; None where the program records no such span."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "elic.transform")
