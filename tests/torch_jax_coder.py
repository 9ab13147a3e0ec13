"""The JAX package's native rANS library, whole before any test loads it.

dcae_tpu/entropy/rans.py builds dcae_tpu/native/librans.so in place when
the file is missing or older than rans.cpp, under a thread lock only, and
loads it under its final name. Processes that start together (pytest-xdist
workers on a fresh copy of the tree, where rans.cpp is the newer file) then
each run the compiler onto the same file, and one of them may load it half
written ("file too short").

ensure_library builds the library as that loader does, but under a file
lock, into a temporary file that then replaces the library whole. The
loader afterwards finds it up to date and builds nothing. The port's test
modules that import the JAX coder call it at import: every xdist worker
imports every test module while collecting, and no test runs before all
have collected, so the library is whole before the first test of a run.

Standard library only, so that a bare interpreter can run it
(tests/test_torch_jax_coder.py starts several at once).
"""

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "dcae_tpu", "native")


def _stale(lib: str, src: str) -> bool:
    """The JAX loader's test for a rebuild."""
    return not os.path.exists(lib) or \
        os.path.getmtime(lib) < os.path.getmtime(src)


def ensure_library(native_dir: str = NATIVE_DIR) -> str:
    """Build `native_dir`/librans.so from rans.cpp if it is missing or
    older, with the JAX loader's command, atomically; returns its path."""
    src = os.path.join(native_dir, "rans.cpp")
    lib = os.path.join(native_dir, "librans.so")
    if not _stale(lib, src):
        return lib
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale(lib, src):            # no other process built it meanwhile
            tmp = f"{lib}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), "-O3", "-std=c++17",
                     "-fPIC", "-shared", "-o", tmp, src],
                    check=True, cwd=native_dir, capture_output=True)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib
