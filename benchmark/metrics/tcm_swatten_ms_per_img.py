"""Host ms an image inside the program's `tcm.swatten` spans (every
SWAtten call of the entropy model, in the encoder's replay and the
decoder alike) over the untraced part of the traced run's window; None
where the program records no such span."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "tcm.swatten")
