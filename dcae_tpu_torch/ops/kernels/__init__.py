"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch statement. A wrapper runs the plain version for CPU tensors and
launches its kernel for CUDA tensors; there is no fallback between the
two."""
