"""Host ms an image in compress_device (its streams fetched): the codec
driver's own spans over the untraced part of the traced run's window."""

from harness import readers


def read(v, name):
    return readers.pre_span_ms_per_image(v, "encode")
