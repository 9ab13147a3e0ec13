"""Share of its least time that the window-8 attention half-blocks of g_a
and g_s take on the device: their work counted from the shapes
(yardstick.window_block_work) over the device time of the wmsa kernels.
In training, forward launches only (the backward recomputes through
plain operations)."""

from harness import readers


def read(v, name):
    return readers.kernel_roofline_pct(v, "wmsa", "wmsa_kernel")
