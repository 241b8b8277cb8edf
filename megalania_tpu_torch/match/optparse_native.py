"""ctypes bindings for the native optimum-parse engine.

The C++ library (megalania_tpu/runtime/native/optparse.cpp, compiled
into the port's build directory by runtime/build.py) implements the
rep-aware exact-ctx-state Viterbi DP and the exact adaptive cost/train
pass; this module owns the layout contract (offset vector from
ops/tables.py) and the numpy marshalling.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import tables as T
from ..runtime import build

# offset vector consumed by optparse.cpp (enum order there)
_OFFSETS = np.asarray([
    T.IS_MATCH, T.IS_REP, T.IS_REP_G0, T.IS_REP_G1, T.IS_REP_G2,
    T.IS_REP0_LONG, T.LEN, T.REP_LEN, T.DIST_SLOT, T.ALIGN, T.POS_CODER,
    T.LIT, T.POS_BITS_MAX, T.MATCH_LEN_MAX,
    T.LEN_CHOICE1, T.LEN_CHOICE2, T.LEN_LOW, T.LEN_MID, T.LEN_HIGH,
], dtype=np.int32)

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


@functools.cache
def _load():
    """The native library (built on first use; raises on failure)."""
    lib = build.host_lib("optparse")
    ct = lib.meg_cost_train
    ct.restype = ctypes.c_int64
    ct.argtypes = [_U8P, ctypes.c_int64, _U32P, _U32P, ctypes.c_int32,
                   _I32P, _I32P, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, _I64P, _I32P, ctypes.c_int64]
    vt = lib.meg_optparse_viterbi
    vt.restype = ctypes.c_int64
    vt.argtypes = [_U8P, ctypes.c_int64, _I32P, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                   _I32P, _I32P, ctypes.c_int32, _I32P, _I32P,
                   ctypes.c_int32, _I64P, _I32P, ctypes.c_int64, _U32P,
                   _U32P]
    lp = lib.meg_lcp
    lp.restype = None
    lp.argtypes = [_U8P, ctypes.c_int64, _I32P, _I32P]
    return lib


def _p(a, t):
    return a.ctypes.data_as(t)


def cost_train(data: np.ndarray, slab: np.ndarray, lc: int = 0,
               nwin: int = 0, win_size: int = 0):
    """Exact adaptive cost of a parse.

    Returns (perplexity, trained_probs[, snapshots]) — snapshots of the
    model at each win_size boundary when nwin > 0 (snapshot w = model
    state entering position w * win_size; window 0 is the fresh model).
    """
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8)
    slab = np.ascontiguousarray(slab, np.uint32)
    probs = np.ascontiguousarray(T.init_probs_np(lc=lc))
    stride = probs.shape[-1]
    snaps = np.zeros((max(nwin, 1), stride), np.int32)
    log2 = np.ascontiguousarray(T.LOG2_TABLE_NP)
    perp = lib.meg_cost_train(
        _p(data, _U8P), len(data), _p(slab, _U32P), None, lc,
        _p(probs, _I32P),
        _p(snaps, _I32P) if nwin > 0 else None, nwin, win_size, stride,
        _p(log2, _I64P), _p(_OFFSETS, _I32P), len(_OFFSETS))
    if perp < 0:
        raise ValueError("malformed slab in native cost_train")
    if nwin > 0:
        return perp, probs, snaps
    return perp, probs


def lcp(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Native Kasai LCP array (semantics of match/suffix.lcp_array)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8)
    sa = np.ascontiguousarray(sa, np.int32)
    out = np.zeros(len(sa), np.int32)
    lib.meg_lcp(_p(data, _U8P), len(data), _p(sa, _I32P), _p(out, _I32P))
    return out


def viterbi_parse(data: np.ndarray, probs_win: np.ndarray,
                  cand_dist: np.ndarray, cand_len: np.ndarray,
                  rank: np.ndarray, sparse: np.ndarray,
                  lc: int = 0, win_size: int = 0) -> np.ndarray:
    """One Viterbi pass over windowed static prices -> packed slab.

    probs_win: [nwin, stride] price snapshots (nwin == 1 reproduces the
    single static-price parse; win_size ignored then)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    probs_win = np.ascontiguousarray(np.atleast_2d(probs_win), np.int32)
    nwin, stride = probs_win.shape
    if win_size <= 0:
        win_size = max(n, 1)
    cand_dist = np.ascontiguousarray(cand_dist, np.int32)
    cand_len = np.ascontiguousarray(cand_len, np.int32)
    M = cand_dist.shape[1] if cand_dist.ndim == 2 else 0
    rank = np.ascontiguousarray(rank, np.int32)
    sparse = np.ascontiguousarray(sparse, np.int32)
    K = sparse.shape[0]
    log2 = np.ascontiguousarray(T.LOG2_TABLE_NP)
    slab = np.empty(n, np.uint32)
    rc = lib.meg_optparse_viterbi(
        _p(data, _U8P), n, _p(probs_win, _I32P), nwin, win_size, stride,
        lc, _p(cand_dist, _I32P), _p(cand_len, _I32P), M,
        _p(rank, _I32P), _p(sparse, _I32P), K, _p(log2, _I64P),
        _p(_OFFSETS, _I32P), len(_OFFSETS), _p(slab, _U32P), None)
    if rc < 0:
        raise ValueError("native viterbi failed")
    return slab
