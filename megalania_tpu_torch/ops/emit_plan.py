"""Compile a final parse into the op stream the native emitter replays.

The live packets are walked on the host (their start positions and the
coder state before each: ctx and rep stack — no probability state, the
emitter adapts probabilities itself), then every packet's bit plan is
built in ONE batched torch call.  Only live packets produce rows; the
native range coder is oblivious to positions.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitplan
from ..models import packets as P


def walk_states(slab: np.ndarray):
    """Live packets of a uint32 slab with the coder state before each:
    (pos, ptype, dist, length, ctx, rep0) int arrays, one entry per live
    packet (rep0 = the rep-stack head, for the matched-literal byte)."""
    ptype, dist, length, _ = P.unpack_np(slab)
    out = []
    ctx, dists = 0, [0, 0, 0, 0]
    pos, n = 0, len(slab)
    while pos < n:
        t, d, ln = int(ptype[pos]), int(dist[pos]), int(length[pos])
        out.append((pos, t, d, ln, ctx, dists[0]))
        if t == P.LIT:
            ctx = 0 if ctx < 4 else (ctx - 3 if ctx < 10 else ctx - 6)
        elif t == P.MATCH:
            ctx = 7 if ctx < 7 else 10
            dists = [d] + dists[:3]
        elif t == P.SREP:
            ctx = 9 if ctx < 7 else 11
        else:
            ctx = 8 if ctx < 7 else 11
            k = min(d, 3)
            dists = [dists[k]] + dists[:k] + dists[k + 1:]
        if ln <= 0:
            break
        pos += ln
    cols = np.asarray(out, np.int64).reshape(-1, 6).T
    return tuple(cols)


def emit_plan(slab: np.ndarray, data, lc: int = 0):
    """-> (pos[P], idx[P,NSLOTS], bit[P,NSLOTS], active[P,NSLOTS] bool,
    n_direct[P], direct_val[P]) as numpy arrays, one row per live packet
    (in position order)."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    pos, t, d, ln, ctx, rep0 = walk_states(np.asarray(slab, np.uint32))
    dat = data.astype(np.int64)
    byte = dat[pos]
    mb = dat[np.clip(pos - rep0 - 1, 0, max(n - 1, 0))]
    prev = np.where(pos > 0, dat[np.maximum(pos - 1, 0)], 0)

    def tt(a):
        return torch.as_tensor(np.asarray(a, np.int32))
    plan = bitplan.make_bit_plan(tt(t), tt(d), tt(ln), tt(ctx), None,
                                 tt(byte), tt(mb), prev_byte=tt(prev), lc=lc)
    return (pos, plan.idx.numpy(), plan.bit.numpy(), plan.active.numpy(),
            plan.n_direct.numpy(), plan.direct_val.numpy())
