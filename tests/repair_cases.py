"""Inputs on which the repair kernel (megalania_tpu_torch/csrc/repair.cu)
is held to its plain version on the card (test_torch_cuda.py), and on
which test_torch_repair.py checks, on the CPU, that the repair changes
packet lengths: the kernel's walker loads the next packet where this
packet's repaired length puts it, and a changed length is where the old
word would put it wrong; and the inputs of the kernels at a deployment's
shape (repair_rows, first_proposal).  No jax.
"""
import os

import numpy as np
import torch

from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.ops import repair_cuda

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


def repair_rows(ctx, cfg, state, rows, window: int, rng):
    """The repair kernel and its plain version at a deployment's shape:
    the kernel at full width (every chain of `state`, so every wave of
    blocks) from its own snapshot `window` positions before the block's
    end, with a mutation substituted in-pass at random sites in the
    window; the plain version (one Python step per position) on `rows`
    of the same inputs.  Two kernel launches.  Returns (the kernel's
    outputs on `rows`, the plain version's)."""
    slab = state.chains.slab
    C, n = slab.shape
    dev = slab.device

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    kw = dict(site_mode=cfg.site_mode, lrep_fallback=cfg.lrep_fallback,
              lc=cfg.lc)
    tabs = (ctx.cand_dist, ctx.cand_len, ctx.log2)
    start = n - window
    snap = repair_cuda.repair_cost_cuda(
        slab, ti(rng.integers(0, n, C)), ti(rng.integers(0, n, C)),
        ctx.data_u8, *tabs, cap_pos=start, **kw)
    q, u = ti(rng.integers(start, n, C)), ti(rng.integers(start, n, C))
    mut0 = ti(P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))
              .view(np.int32))
    mut1 = ti(P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2))
              .view(np.int32))
    got = repair_cuda.repair_cost_cuda(
        snap[0], q, u, ctx.data_u8, *tabs, mut0=mut0, mut1=mut1,
        start_pos=start, probs_in=snap[3], carry_in=snap[8], **kw)
    r = torch.as_tensor(list(rows), device=dev)
    want = repair_cuda.repair_cost_plain(
        snap[0][r], q[r], u[r], ctx.data, *tabs, mut0=mut0[r], mut1=mut1[r],
        start_pos=start, probs_in=snap[3][r], carry_in=snap[8][r], **kw)
    return tuple(g[r] for g in got), want


def first_proposal(ctx, state, cfg):
    """(arguments, keywords) of propose_cuda and propose_plain for the
    main path's first iteration from a fresh state: a fresh sweep (sites
    and stack from the zero carry where a chain's recorded site ran off
    the end), stratum 0."""
    ch = state.chains
    n = ctx.data.shape[0]
    fresh = ch.rec_live >= n
    q = torch.where(fresh, 0, ch.rec_live)
    rec_ctx = torch.where(fresh, 0, ch.rec_ctx)
    rec_dists = torch.where(fresh[:, None], 0, ch.rec_dists)
    return ((ch.key, state.skey, ch.slab, q, rec_ctx, rec_dists,
             ch.rank_probs, ch.live_count, ctx),
            dict(proposals=cfg.proposals, top_k=cfg.top_k,
                 sublens=cfg.sublens, lc=cfg.lc, u_lo=0,
                 span=engine.choose_tile(n, cfg.chain_block, cfg.lc)))
