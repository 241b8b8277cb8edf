"""Class-decomposed probability layout, the one the CUDA kernels keep in
shared memory.

The flat 1792-slot model (ops/tables.py) is split into small per-slot
*classes*.  Bit-tree groups are decomposed *by level*: level j of an MSB
tree holds nodes m in [2^j, 2^(j+1)), whose level offset is
value >> (nbits - j) — so each of the 26 bit slots addresses exactly one
small class.  (Same idea for the LSB/reverse trees of the distance
coder.)  A slot's prob row is then `ROW[class] + within-class index`.

This module owns the enumeration: for every class entry, its flat index
in the tables.py layout, plus the inverse permutation used to reassemble
flat probability vectors (the plain repair pass, ops/repair_scan.py,
works on the flat layout; rank_probs is class-packed at every public
boundary).

Semantics reference: the reference's src/lzma_packet_encoder.c:5-194
(bit order), lzma_state.h:15-55 (model groups); this file only re-indexes
the model, it does not change a single probability.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tables as T


def _pad8(k: int) -> int:
    return -(-k // 8) * 8


class ClassSpec:
    def __init__(self, name: str, flat_ids):
        self.name = name
        self.flat = np.asarray(flat_ids, np.int32)
        self.width = len(self.flat)
        self.rows = _pad8(self.width)
        self.row0 = -1  # filled by _build

    def __repr__(self):
        return f"<cls {self.name} w{self.width} @{self.row0}>"


def _ltree_class(j: int) -> ClassSpec:
    """Length-coder trees, level j.  tsel order must match the kernel:
    j<3: {m.low, m.mid, r.low, r.mid, m.high, r.high}; j>=3: {m.high,
    r.high}."""
    if j < 3:
        sels = [(T.LEN, T.LEN_LOW), (T.LEN, T.LEN_MID),
                (T.REP_LEN, T.LEN_LOW), (T.REP_LEN, T.LEN_MID),
                (T.LEN, T.LEN_HIGH), (T.REP_LEN, T.LEN_HIGH)]
    else:
        sels = [(T.LEN, T.LEN_HIGH), (T.REP_LEN, T.LEN_HIGH)]
    ids = []
    for coder, tree in sels:
        for o in range(1 << j):
            ids.append(coder + tree + (1 << j) + o)
    return ClassSpec(f"ltree{j}", ids)


def _dst_class(j: int) -> ClassSpec:
    """Distance pos-slot tree (6-bit MSB tree x 4 len contexts), level j."""
    ids = []
    for c in range(4):
        for o in range(1 << j):
            ids.append(T.DIST_SLOT + 64 * c + (1 << j) + o)
    return ClassSpec(f"dst{j}", ids)


# Reverse-tree (pos_coder/align) plumbing.  pos slots 4..13 each own a
# reverse tree of nlb=(ps>>1)-1 bits at base POS_CODER+(high<<nlb)-ps
# (bitplan.make_bit_plan); align (ps>=14) is a 4-bit tree at ALIGN.
RT_PS = list(range(4, 14))                      # tree ids 0..9
RT_NLB = [(ps >> 1) - 1 for ps in RT_PS] + [4]  # id 10 = align
RT_BASE_OFF = [((2 | (ps & 1)) << ((ps >> 1) - 1)) - ps for ps in RT_PS]


def _rt_class(t: int):
    """Reverse trees, level t.  Returns (spec, per-tree offset row)."""
    ids, offs = [], np.zeros(11, np.int32)
    for tid in range(11):
        if RT_NLB[tid] <= t:
            continue
        offs[tid] = len(ids)
        base = (T.POS_CODER + RT_BASE_OFF[tid]) if tid < 10 else T.ALIGN
        for o in range(1 << t):
            ids.append(base + (1 << t) + o)
    return ClassSpec(f"rt{t}", ids), offs


def _build(lc: int = 0):
    classes = [
        ClassSpec("ismatch", T.IS_MATCH + np.arange(12)),
        ClassSpec("isrep", T.IS_REP + np.arange(12)),
        ClassSpec("g0", T.IS_REP_G0 + np.arange(12)),
        ClassSpec("g1r0l", np.concatenate([T.IS_REP_G1 + np.arange(12),
                                           T.IS_REP0_LONG + np.arange(12)])),
        ClassSpec("g2", T.IS_REP_G2 + np.arange(12)),
        ClassSpec("lch", [T.LEN + T.LEN_CHOICE1, T.REP_LEN + T.LEN_CHOICE1,
                          T.LEN + T.LEN_CHOICE2, T.REP_LEN + T.LEN_CHOICE2]),
    ]
    classes += [_ltree_class(j) for j in range(8)]
    classes += [_dst_class(j) for j in range(6)]
    rt_offs = np.zeros((5, 11), np.int32)
    for t in range(5):
        spec, offs = _rt_class(t)
        classes.append(spec)
        rt_offs[t] = offs
    # the literal class covers all 2^lc contexts (lc>0 only grows this
    # tail class; every other class offset is lc-independent)
    classes.append(ClassSpec("lit", T.LIT + np.arange(T.lit_size(lc))))

    row = 0
    by_name = {}
    for c in classes:
        c.row0 = row
        row += c.rows
        by_name[c.name] = c

    flat_all = np.concatenate([c.flat for c in classes])
    assert len(np.unique(flat_all)) == len(flat_all), "overlapping classes"
    assert flat_all.min() >= 0 and flat_all.max() < T.num_probs(lc)

    # flat -> packed row (or -1 for flat slots no class covers: the
    # layout's alignment pads, which stay at PROB_INIT forever)
    perm = np.full(T.num_probs(lc), -1, np.int32)
    for c in classes:
        perm[c.flat] = c.row0 + np.arange(c.width)
    return classes, by_name, row, perm, rt_offs


class Layout:
    """All packed-layout tables for one lc (ops/tables.py flat layout of
    the same lc on the other side).  lc=0 is the module-level default;
    lc>0 only widens the trailing `lit` class."""

    def __init__(self, lc: int = 0):
        self.lc = lc
        (self.CLASSES, self.BY_NAME, self.PACKED_ROWS,
         self.FLAT_TO_PACKED, self.RT_OFFSETS) = _build(lc)
        self.ROW = {c.name: c.row0 for c in self.CLASSES}
        self.WIDTH = {c.name: c.width for c in self.CLASSES}
        self.ROWS = {c.name: c.rows for c in self.CLASSES}
        self.PACKED_TO_FLAT = np.full(self.PACKED_ROWS, -1, np.int32)
        for c in self.CLASSES:
            self.PACKED_TO_FLAT[c.row0:c.row0 + c.width] = c.flat
        self.F2P_PAD = np.full(T.probs_pad(lc), -1, np.int32)
        self.F2P_PAD[:T.num_probs(lc)] = self.FLAT_TO_PACKED

    def flat_from_packed(self, packed_cT):
        """[C, PACKED_ROWS] -> [C, PROBS_PAD] flat probability vectors.

        Uncovered flat slots (alignment pads) are PROB_INIT; PROBS_PAD
        tail padding is 0, matching tables.init_probs_np.
        """
        f2p = torch.as_tensor(self.FLAT_TO_PACKED, dtype=torch.long,
                              device=packed_cT.device)
        C = packed_cT.shape[0]
        out = torch.zeros((C, T.probs_pad(self.lc)), dtype=torch.int32,
                          device=packed_cT.device)
        out[:, :T.num_probs(self.lc)] = torch.where(
            f2p >= 0, packed_cT[:, f2p.clamp(min=0)], T.PROB_INIT)
        return out

    def packed_from_flat(self, flat_c):
        """[C, PROBS_PAD] flat vectors -> [C, PACKED_ROWS] class layout.

        Alignment pad rows get PROB_INIT (they are never read by slot
        math, but keeping them at init matches a fresh kernel state
        bit-for-bit).
        """
        p2f = torch.as_tensor(self.PACKED_TO_FLAT, dtype=torch.long,
                              device=flat_c.device)
        return torch.where(p2f >= 0, flat_c[:, p2f.clamp(min=0)],
                           T.PROB_INIT).to(torch.int32)


_LAYOUTS: dict = {}


def get_layout(lc: int = 0) -> Layout:
    if lc not in _LAYOUTS:
        _LAYOUTS[lc] = Layout(lc)
    return _LAYOUTS[lc]


# lc=0 module-level tables (historical interface; the kernels and most
# callers run the lc=0 model, matching the reference's hardcoded lc=0)
_L0 = get_layout(0)
CLASSES, BY_NAME, PACKED_ROWS = _L0.CLASSES, _L0.BY_NAME, _L0.PACKED_ROWS
FLAT_TO_PACKED, RT_OFFSETS = _L0.FLAT_TO_PACKED, _L0.RT_OFFSETS
ROW, WIDTH, ROWS = _L0.ROW, _L0.WIDTH, _L0.ROWS
PACKED_TO_FLAT, F2P_PAD = _L0.PACKED_TO_FLAT, _L0.F2P_PAD


def flat_from_packed(packed_cT):
    return _L0.flat_from_packed(packed_cT)


def packed_from_flat(flat_c):
    return _L0.packed_from_flat(flat_c)
