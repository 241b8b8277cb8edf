"""Host emission: parse -> .lzma bytes via the native op-stream emitter.

The op stream comes from ops/emit_plan.py (the bit plan is the single
source of truth for bit order); the C++ range coder,
megalania_tpu/runtime/native/emitter.cpp built into the port's build
directory, only replays it.  A failed build raises: the port has no
fallback emitter (runtime/pyemit.py is the test oracle).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import bitplan, emit_plan, tables as T
from . import build, pyemit


@functools.cache
def _load():
    fn = build.host_lib("emitter").meg_emit_opstream
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # idx
        ctypes.POINTER(ctypes.c_int32),   # bit
        ctypes.POINTER(ctypes.c_uint8),   # active
        ctypes.POINTER(ctypes.c_int32),   # n_direct
        ctypes.POINTER(ctypes.c_int32),   # direct_val
        ctypes.c_int64,                   # n_positions
        ctypes.c_int32,                   # nslots
        ctypes.c_int32,                   # direct_after
        ctypes.c_int32,                   # num_probs
        ctypes.POINTER(ctypes.c_uint8),   # header
        ctypes.c_int64,                   # header_len
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.c_int64,                   # out_cap
    ]
    return fn


def emit_from_opstream(idx, bit, active, n_direct, direct_val,
                       header: bytes, lc: int = 0) -> bytes:
    """Replay an op stream (numpy arrays, one row per packet) through the
    native range coder."""
    fn = _load()
    idx = np.ascontiguousarray(idx, np.int32)
    bit = np.ascontiguousarray(bit, np.int32)
    active = np.ascontiguousarray(active, np.uint8)
    n_direct = np.ascontiguousarray(n_direct, np.int32)
    direct_val = np.ascontiguousarray(direct_val, np.int32)
    rows, nslots = idx.shape
    hdr = np.ascontiguousarray(np.frombuffer(header, np.uint8))
    # worst case ~11 bits per bit-op plus direct bits; be generous
    cap = len(header) + 16 + 2 * nslots * max(rows, 1) + 8 * max(rows, 1)
    out = np.empty(cap, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    size = fn(p(idx, ctypes.c_int32), p(bit, ctypes.c_int32),
              p(active, ctypes.c_uint8), p(n_direct, ctypes.c_int32),
              p(direct_val, ctypes.c_int32), rows, nslots,
              bitplan._DIRECT_AFTER_SLOT, T.num_probs(lc),
              p(hdr, ctypes.c_uint8), len(header), p(out, ctypes.c_uint8),
              cap)
    if size < 0:
        raise RuntimeError("native emitter buffer overflow")
    return out[:size].tobytes()


def emit(data: bytes, slab: np.ndarray, dict_size: int = 0x400000,
         lc: int = 0) -> bytes:
    """Parse (uint32 slab) -> complete .lzma stream."""
    _, idx, bit, active, n_direct, direct_val = emit_plan.emit_plan(
        slab, data, lc=lc)
    header = pyemit.lzma_header(len(data), lc=lc, dict_size=dict_size)
    return emit_from_opstream(idx, bit, active, n_direct, direct_val,
                              header, lc=lc)
