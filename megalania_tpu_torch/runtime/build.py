"""Builds the port's native libraries from the repository's sources.

Two kinds of library, each built at first use into
`megalania_tpu_torch/_build/` under a name keyed by a hash of its sources
and flags, so a stale build is never loaded:

  * the CUDA kernels: every `megalania_tpu_torch/csrc/*.cu` (plus the
    shared header) compiled by nvcc for sm_90a into ONE shared library
    with a plain C interface, loaded with ctypes (no PyTorch headers, so
    the build takes seconds);
  * the host engines `megalania_tpu_torch/native/{optparse,emitter}.cpp`
    compiled by g++.  Their code is the reference's `runtime/native`
    sources line for line, known defects included (the parity tests hold
    them against the reference's own build); only comments differ.  The
    port reads no file of the reference package.

A failed build raises: nothing falls back to another implementation.
Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
NATIVE_SRC = os.path.join(_PKG, "native")

# no --use_fast_math: the log2 probe and the proposal kernel must run the exact
# float32 log2 sequence the correction table was built from
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _digest(paths, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(name: str, cmd: list, sources: list, inputs: list) -> str:
    """Compile `sources` with `cmd` into _build/<name>-<hash>.so (the hash
    covers `inputs`, headers included); reuse an existing build."""
    out = os.path.join(BUILD_DIR, f"{name}-{_digest(inputs, cmd)}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=name, suffix=".tmp")
    os.close(fd)
    proc = subprocess.run(cmd + ["-o", tmp] + sources, capture_output=True,
                          text=True)
    with open(out[:-3] + ".log", "w") as f:   # compiler report (ptxas -v)
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {name} failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)                      # atomic: parallel builds
    return out


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


@functools.cache
def cuda_lib_path(defines: tuple = ()) -> str:
    """Build (once per source hash and macro set) the CUDA kernel library;
    its path.  `defines` are preprocessor macros (a profiling build)."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    inputs = sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    cmd = [_nvcc()] + NVCC_FLAGS + [f"-D{d}" for d in defines]
    return _build("libmeg_cuda", cmd, sources, inputs)


@functools.cache
def cuda_lib() -> ctypes.CDLL:
    return ctypes.CDLL(cuda_lib_path())


@functools.cache
def host_lib(name: str) -> ctypes.CDLL:
    """The g++ build of megalania_tpu_torch/native/<name>.cpp
    (name: "optparse" or "emitter")."""
    src = os.path.join(NATIVE_SRC, f"{name}.cpp")
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    path = _build(f"libmeg_{name}", [cxx] + GXX_FLAGS, [src], [src])
    return ctypes.CDLL(path)
