"""tests/torch_jax_coder.py's build of the JAX package's rANS library:
several processes started at once against one copy of the native
directory, as pytest-xdist workers start on a fresh tree, each load a
whole library, and it is compiled once (or not at all when it is up to
date)."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from tests import torch_jax_coder

WORKERS = 6

# one worker: build if needed, load, and call into the library
_WORKER = textwrap.dedent("""
    import ctypes, sys
    sys.path.insert(0, sys.argv[1])
    import torch_jax_coder
    lib = ctypes.CDLL(torch_jax_coder.ensure_library(sys.argv[2]))
    pmf = (ctypes.c_float * 3)(0.25, 0.5, 0.25)
    cdf = (ctypes.c_int32 * 4)()
    f = lib.dcae_pmf_to_quantized_cdf
    f.restype = ctypes.c_int32
    f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                  ctypes.c_void_p]
    print(f(pmf, 3, 16, cdf), list(cdf))
""")


@pytest.mark.parametrize("state", ["missing", "stale", "truncated",
                                   "fresh"])
def test_concurrent_builds_load_a_whole_library(tmp_path, state):
    whole = torch_jax_coder.ensure_library()
    native = tmp_path / "native"
    native.mkdir()
    shutil.copy2(os.path.join(torch_jax_coder.NATIVE_DIR, "rans.cpp"),
                 native / "rans.cpp")
    lib = native / "librans.so"
    src_time = os.path.getmtime(native / "rans.cpp")
    if state != "missing":
        shutil.copyfile(whole, lib)
        if state == "truncated":            # what a lost race left behind
            lib.write_bytes(lib.read_bytes()[:100])
        t = src_time + (10 if state == "fresh" else -10)
        os.utime(lib, (t, t))
    before = os.stat(lib) if state == "fresh" else None
    # the compiler, counting its calls
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f'#!/bin/sh\necho x >> "{log}"\n'
                   f'exec "{os.environ.get("CXX", "g++")}" "$@"\n')
    cxx.chmod(0o755)
    env = {**os.environ, "CXX": str(cxx)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, os.path.dirname(__file__),
         str(native)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(WORKERS)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    # the quantized CDF of (1/4, 1/2, 1/4), from every process
    assert [out for out, _ in outs] == \
        ["0 [0, 16384, 49152, 65536]\n"] * WORKERS
    calls = len(log.read_text().split()) if log.exists() else 0
    assert calls == (0 if state == "fresh" else 1)
    # no temporary file is left, and the JAX loader would build nothing
    assert sorted(os.listdir(native)) == (
        ["librans.so", "rans.cpp"] if state == "fresh"
        else ["librans.so", "librans.so.lock", "rans.cpp"])
    assert os.path.getmtime(lib) >= src_time
    if state == "fresh":
        after = os.stat(lib)
        assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                     before.st_mtime_ns)
