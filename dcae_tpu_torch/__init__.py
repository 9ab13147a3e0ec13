"""dcae_tpu_torch: the DCAE codec in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package `dcae_tpu`, which stays the reference. It
imports neither JAX nor anything of `dcae_tpu`. Public tensors are NHWC;
parameter names are the reference's torch state dict; the fused TPU
kernels are hand-written CUDA kernels in `csrc/`, built at first use.
"""
