"""Share of its least time that the gated MLPs of 128-multiple widths
(g_a / g_s stage 3, the dictionary attention's) take on the device: their
work counted from the shapes (yardstick.glu_work) over the device time of
the conv_glu kernels. In training, forward launches only."""

from harness import readers


def read(v, name):
    return readers.kernel_roofline_pct(v, "glu", "conv_glu_kernel")
