"""Inputs on which the repair kernel (megalania_tpu_torch/csrc/repair.cu)
is held to its plain version on the card (test_torch_cuda.py), and on
which test_torch_repair.py checks, on the CPU, that the repair changes
packet lengths: the kernel's walker loads the next packet where this
packet's repaired length puts it, and a changed length is where the old
word would put it wrong.  Plain numpy: no jax.
"""
import os

import numpy as np

from megalania_tpu_torch.models import packets as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIBC = os.path.join(ROOT, "tools", "corpus", "libc.so")
DATA = open(_LIBC, "rb").read()[4096:4096 + 1024]
# three of the kernel's 1,024-position slab tiles: two edges inside
EDGE_DATA = open(_LIBC, "rb").read()[4096:4096 + 3072]
C = 8
TILE = 1024             # csrc/repair.cu kTile
# literals before a planted edge packet: longer than any match (273), so
# every chain's walk reaches the packet
RUN = 288


def kernel_inputs(ctx, rng, *, edges=False, packet_sites=False):
    """(slabs [C, n] uint32, q [C], u [C]) as numpy, drawn from `rng`:
    the context's seed parse with 6 long reps (length 2) and 6 short reps
    planted at random in each chain; q in [0, n / 2); u a position, or a
    packet ordinal below 64.  With `edges`, before each tile edge e a run
    of literals, then in chain c long reps of length 2 at e - 1 - c % 2
    and the next position, so that a long rep's re-aim or fallback
    decides whether the next packet lies in this tile or the next."""
    n = ctx.data.shape[0]
    slabs = np.broadcast_to(P.to_u32(ctx.init_slab), (C, n)).copy()
    for c in range(C):
        for _ in range(6):
            slabs[c, int(rng.integers(1, n))] = P.pack_np(
                P.LREP, int(rng.integers(0, 4)), 2)
            slabs[c, int(rng.integers(1, n))] = P.pack_np(P.SREP, 0, 1)
    if edges:
        for e in range(TILE, n, TILE):
            slabs[:, e - 1 - RUN:e - 1] = P.pack_np(P.LIT, 0, 1)
            for c in range(C):
                at = e - 1 - c % 2
                slabs[c, at] = P.pack_np(P.LREP, c % 4, 2)
                slabs[c, at + 1] = P.pack_np(P.LREP, (c + 1) % 4, 2)
    q = rng.integers(0, n // 2, C).astype(np.int32)
    u = rng.integers(0, 64 if packet_sites else n, C).astype(np.int32)
    return slabs, q, u
