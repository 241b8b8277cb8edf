"""ctypes binding of the CUDA kernel library (megalania_tpu_torch/csrc).

The library is built on first use (runtime/build.py); its entry points
take raw device pointers and PyTorch's current CUDA stream, launch, and
return cudaGetLastError().  The wrappers in ops/*_cuda.py check their
tensors, allocate outputs and call through here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import problayout as PL
from ..runtime import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "meg_log2_probe": [_P, _P],
    "meg_repair": [_P] * 17 + [_I] * 7 + [_P, _P],
    "meg_rank": [_P] * 5 + [_I] * 4 + [_P, _P],
}


@functools.cache
def lib() -> ctypes.CDLL:
    so = build.cuda_lib()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return so


@functools.cache
def layout_array(lc: int) -> np.ndarray:
    """meg::Layout as int32[26 + 5*11]: each class's first packed row (in
    problayout order), then the reverse-tree offsets."""
    lay = PL.get_layout(lc)
    rows = [c.row0 for c in lay.CLASSES]
    return np.ascontiguousarray(
        np.concatenate([np.asarray(rows, np.int32),
                        lay.RT_OFFSETS.reshape(-1).astype(np.int32)]))


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")


def require(t: torch.Tensor, name: str, shape=None, dtype=torch.int32):
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape (None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
