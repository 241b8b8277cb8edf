"""Packed packet representation.

The annealing genome ("slab", reference: src/packet_slab.h:5) is one
packet per byte position, each packed into a single 32-bit word:

    bits  0..19  dist   (MATCH: distance-1; LREP: rep-stack index 0..3)
    bits 20..28  len    (1..273)
    bits 29..30  type   (LIT=0, MATCH=1, SREP=2, LREP=3)
    bit  31      live   (set by the costing pass: position is a packet start)

dist < 2**20 limits blocks to 1 MiB.

Torch has no full uint32 arithmetic, so slabs live in int32 tensors that
hold the uint32 bit patterns: the live bit is the sign bit, and every
field is read with a mask (`(w >> 31) & 1` — an arithmetic shift fills
with ones).  Compare with the reference's uint32 arrays through
`.numpy().view(np.uint32)` (`to_u32`).
"""
from __future__ import annotations

import numpy as np
import torch

LIT = 0
MATCH = 1
SREP = 2
LREP = 3

DIST_BITS = 20
LEN_SHIFT = 20
TYPE_SHIFT = 29
LIVE_SHIFT = 31

DIST_MASK = (1 << DIST_BITS) - 1
LEN_MASK = (1 << 9) - 1
TYPE_MASK = 3

MAX_BLOCK = 1 << DIST_BITS
LIVE_BIT = -(1 << LIVE_SHIFT)        # bit 31 as an int32 value
NOT_LIVE = (1 << LIVE_SHIFT) - 1     # mask clearing bit 31


def pack(ptype, dist, length, live=0):
    """Pack packet fields (int tensors, broadcastable) into int32 words."""
    w = ((torch.as_tensor(dist) & DIST_MASK)
         | ((torch.as_tensor(length) & LEN_MASK) << LEN_SHIFT)
         | ((torch.as_tensor(ptype) & TYPE_MASK) << TYPE_SHIFT))
    w = w.to(torch.int32)
    live = torch.as_tensor(live, device=w.device)
    return torch.where(live != 0, w | LIVE_BIT, w)


def unpack(word):
    """-> (type, dist, len, live) as int32 tensors."""
    word = torch.as_tensor(word, dtype=torch.int32)
    ptype = (word >> TYPE_SHIFT) & TYPE_MASK
    dist = word & DIST_MASK
    length = (word >> LEN_SHIFT) & LEN_MASK
    live = (word >> LIVE_SHIFT) & 1
    return ptype, dist, length, live


def to_u32(t) -> np.ndarray:
    """int32 tensor of packed words -> the reference's np.uint32 view."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def from_u32(a, device=None) -> torch.Tensor:
    """np.uint32 packed words -> int32 tensor holding the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def pack_np(ptype, dist, length, live=0):
    ptype = np.asarray(ptype, np.uint32)
    dist = np.asarray(dist, np.uint32)
    length = np.asarray(length, np.uint32)
    live = np.asarray(live, np.uint32)
    return (
        (dist & DIST_MASK)
        | ((length & LEN_MASK) << LEN_SHIFT)
        | ((ptype & TYPE_MASK) << TYPE_SHIFT)
        | ((live & 1) << np.uint32(LIVE_SHIFT))
    ).astype(np.uint32)


def unpack_np(word):
    word = np.asarray(word, np.uint32)
    ptype = ((word >> TYPE_SHIFT) & TYPE_MASK).astype(np.int32)
    dist = (word & DIST_MASK).astype(np.int32)
    length = ((word >> LEN_SHIFT) & LEN_MASK).astype(np.int32)
    live = (word >> np.uint32(LIVE_SHIFT)).astype(np.int32)
    return ptype, dist, length, live


def literal_slab(n: int) -> np.ndarray:
    """All-literal initial parse (reference: packet_slab.c:30-32)."""
    return pack_np(
        np.full(n, LIT), np.zeros(n, np.uint32), np.ones(n, np.uint32)
    )
