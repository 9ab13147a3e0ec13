"""Build and load the port's native code at first use.

Every source is compiled into a plain-C shared library under `build/` at
the repository root (listed in .gitignore) and loaded with ctypes. The
library's file name carries a hash of the source and the compiler command,
so an edited source never meets a stale library. Builds take a file lock,
so concurrent processes (pytest workers, a server's threads) build each
library once.

CUDA sources (`csrc/*.cu`) are built with nvcc for sm_90a (Hopper); the
rANS coder (`native/rans.cpp`) with g++.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dcae_tpu_torch")
CSRC_DIR = os.path.join(_PKG, "csrc")

# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

SMEM_LIMIT = 232448  # shared memory one block may use on sm_90, bytes

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # compiler output of this process's builds


class BuildError(RuntimeError):
    """A native source failed to compile."""


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else in the toolkit at $CUDA_HOME (by
    default the toolkit's usual install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise BuildError("nvcc not found on PATH or in $CUDA_HOME/bin: the "
                     "CUDA kernels need the CUDA toolkit")


def _target(src: str, cmd: Sequence[str]) -> str:
    digest = hashlib.sha256(" ".join(cmd).encode())
    # a CUDA source includes the headers beside it: they are part of it
    deps = [src] + (sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")) if src.endswith(".cu") else [])
    for dep in deps:
        with open(dep, "rb") as f:
            digest.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _compile_cmd(src: str) -> List[str]:
    if src.endswith(".cu"):
        return [nvcc_path(), *NVCC_FLAGS]
    return [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
            "-shared"]


def _start(src: str):
    """Start building `src` unless its library exists. Returns
    (target, lock_file, process or None)."""
    cmd = _compile_cmd(src)
    target = _target(src, cmd)
    if os.path.exists(target):
        return target, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    lock = open(target + ".lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    if os.path.exists(target):          # another process built it meanwhile
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
        return target, None, None
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.Popen([*cmd, "-o", tmp, src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, lock, proc


def _finish(src: str, target: str, lock, proc) -> str:
    if proc is None:
        return target
    try:
        out, _ = proc.communicate()
        tmp = f"{target}.{os.getpid()}.tmp"
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise BuildError(f"building {src} failed "
                             f"(rc={proc.returncode}):\n{out}")
        os.replace(tmp, target)
        build_logs[src] = out
    finally:
        fcntl.flock(lock, fcntl.LOCK_UN)
        lock.close()
    return target


def build(sources: Sequence[str]) -> List[str]:
    """Build every source that has no library yet, all compilers running at
    once; returns the library paths in order. Raises BuildError."""
    started = [(src, *_start(src)) for src in sources]
    return [_finish(*s) for s in started]


def load(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _loaded.get(src)
        if lib is None:
            (path,) = build([src])
            lib = ctypes.CDLL(path)
            _loaded[src] = lib
        return lib


def kernel_sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def build_kernels() -> List[str]:
    """Build every CUDA kernel library in parallel (one nvcc per source)."""
    return build(kernel_sources())


def load_kernel(name: str) -> ctypes.CDLL:
    return load(os.path.join(CSRC_DIR, f"{name}.cu"))


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def bind(lib: ctypes.CDLL, name: str, n_ptrs: int, n_ints: int):
    """Declare a kernel entry `int name(void* x n_ptrs, int x n_ints,
    void* stream)` and return it."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    return fn


def bind_query(lib: ctypes.CDLL, name: str, n_ints: int):
    """Declare a host-side query `long long name(int x n_ints)`."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * n_ints
    return fn


def kernel_operands(what: str, x, params: Sequence) -> None:
    """Check what the kernels take: CUDA tensors on x's device, all of x's
    dtype (float32 or bfloat16), contiguous, 16-byte aligned."""
    import torch

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {x.dtype} (float32 or bfloat16)")
    for t in (x, *params):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: operand dtype {t.dtype} != {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")
