"""Host ms an image in decompress_interleaved up to x_hat synchronised:
the codec driver's own spans over the untraced part of the traced run's
window."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "decode")
