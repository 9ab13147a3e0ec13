"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch statement. A wrapper runs the plain version for CPU tensors and
launches its kernel for CUDA tensors; there is no fallback between the
two."""

from dcae_tpu_torch.utils.profiling import sinks


def note_launch(name: str, flops: int, *tensors) -> None:
    """Tell the registered sinks (utils/profiling.py) of one launch: its
    operations (an FMA is two) and the bytes of `tensors`, each read or
    written once. The kernels run through ctypes, where no
    dispatcher-level counter sees them."""
    if sinks:
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        for sink in list(sinks):
            sink.launch(name, int(flops), int(nbytes))


def wrappers() -> dict:
    """Every kernel wrapper by name; each counts its kernel's launches in
    its `.launches` attribute."""
    from dcae_tpu_torch.ops.kernels.conv2d_nhwc import conv2d_nhwc
    from dcae_tpu_torch.ops.kernels.conv_glu import conv_glu
    from dcae_tpu_torch.ops.kernels.rans_lanes import (rans_lanes_decode,
                                                       rans_lanes_encode)
    from dcae_tpu_torch.ops.kernels.wmsa_attention import wmsa_attention
    from dcae_tpu_torch.ops.kernels.wmsa_block import wmsa_block

    return {"wmsa_block": wmsa_block, "conv_glu": conv_glu,
            "wmsa_attention": wmsa_attention,
            "rans_lanes_encode": rans_lanes_encode,
            "rans_lanes_decode": rans_lanes_decode,
            "conv2d_nhwc": conv2d_nhwc}
