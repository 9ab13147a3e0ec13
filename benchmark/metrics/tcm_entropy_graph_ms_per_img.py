"""Host ms an image inside the program's `codec.entropy.graph` spans (the
copy in, replay and copy out of the entropy pass's CUDA graph, encoder
replay and decoder alike) over the untraced part of the traced run's
window; None where the program records no such span."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "codec.entropy.graph")
