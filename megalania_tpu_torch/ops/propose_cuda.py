"""Kernel 3: the proposal stage of one anneal iteration.

For each row (chains x proposals): the key schedule, the candidate set at
the row's site, each candidate's exact bit cost under the chain's
snapshot probabilities (metric = cost // max(len, 1), BIG where
invalid), the biased top-K choice and the boundary moves that give the
two mutated cells, the recording-site draw, and per chain the acceptance
uniform and the next key.  None of it reads the repair pass, so one
launch does it all before the repair kernel.

`propose` dispatches on the device: the CUDA kernel (csrc/propose.cu) on
cuda, `propose_plain` on cpu; on a CUDA tensor it launches or raises.

Replaces: megalania_tpu/ops/pallas_rank.py::_kernel (wrapper
rank_pallas), the candidate ranking, which the kernel now carries
together with the torch ops of the proposal stage (enumeration, the
mutation choice and every threefry draw of the iteration).  Bound on
the card: latency, not bytes — the probabilities (~7 KB a row) and a
few gathers take well under a microsecond of HBM time; the kernel's
time is the dependent chains of ~62 candidates x 26 slots and ~35
threefry hashes per row.  One block per row (two warps rank, a third
hashes the keys).
"""
from __future__ import annotations

import torch

from . import bitplan, cuda_lib
from . import problayout as PL
from . import tables as T
from ..anneal import moves
from ..models import packets as P
from ..utils import threefry as R

BIG = 2 ** 30


def rank_plain(probs, candp, rec_ctx, rec_dists, byte, match_byte,
               prev_byte, lc: int = 0):
    """probs [C, PACKED_ROWS]; candp [C, NC] packed words; rec_ctx,
    byte, match_byte, prev_byte [C]; rec_dists [C, 4] -> int32[C, NC]."""
    dev = probs.device
    ptype, dist, length, valid = P.unpack(candp)
    plan = bitplan.make_bit_plan(ptype, dist, length, rec_ctx[:, None],
                                 rec_dists, byte[:, None],
                                 match_byte[:, None],
                                 prev_byte=prev_byte[:, None], lc=lc)
    log2 = torch.as_tensor(T.LOG2_TABLE_I32, device=dev)
    f2p = torch.as_tensor(PL.get_layout(lc).F2P_PAD, device=dev)
    cost = bitplan.plan_cost_packed(probs, plan, log2, f2p, lc=lc)
    metric = cost // torch.clamp(length, min=1)
    return torch.where(valid == 1, metric, BIG).to(torch.int32)


def propose_plain(keys, skey, slab, q, rec_ctx, rec_dists, rank_probs,
                  live_count, ctx, *, proposals, top_k, sublens, lc,
                  u_lo=0, span=None):
    """The plain version: the torch sequence of the engine's proposal
    stage.

    keys [Cn, 2] and skey [2] (int64 threefry keys); slab [Cn, n]; q,
    rec_ctx, live_count [Cn]; rec_dists [Cn, 4]; rank_probs [Cn,
    PACKED_ROWS]; ctx: a BlockContext (data, rank, sparse, cand_*).
    Sites: u_lo + randint(0, span) per row, or, with span None, a packet
    ordinal below the chain's live_count.  Rows are chain-major, chain c
    proposal p at c * proposals + p.

    Returns (key_next [Cn, 2], skey_next [2], v0, v1, u [rows] int32,
    acc_u [Cn] float32, metric [rows, NC] int32)."""
    Cn, Pn = keys.shape[0], proposals
    ks = R.split(keys, 4)
    key_next, k_prop, k_u, k_acc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    skey_next = R.split(skey, 2)[0]
    if Pn > 1:
        k_prop = R.split(k_prop, Pn).reshape(Cn * Pn, 2)
        k_u = R.split(k_u, Pn).reshape(Cn * Pn, 2)
        slab, q, rec_ctx, rec_dists, rank_probs, live_count = (
            torch.repeat_interleave(x, Pn, 0) for x in (
                slab, q, rec_ctx, rec_dists, rank_probs, live_count))
    cands = moves.enumerate_candidates(
        slab, q, rec_dists, ctx.data, ctx.rank, ctx.sparse, ctx.cand_dist,
        ctx.cand_len, ctx.cand_count, sublens=sublens)
    metric = rank_plain(rank_probs, moves.pack_candidates(cands), rec_ctx,
                        rec_dists, *moves.site_bytes(ctx.data, q, rec_dists),
                        lc=lc)
    v0, v1 = moves.select_mutation(slab, q, rec_dists, cands, metric, k_prop,
                                   ctx.data, top_k=top_k)
    if span is None:
        u = R.randint(k_u, (), 0, torch.clamp(live_count, min=1))
    else:
        u = u_lo + R.randint(k_u, (), 0, span)
    return (key_next, skey_next, v0, v1, u.to(torch.int32), R.uniform(k_acc),
            metric)


def propose_cuda(keys, skey, slab, q, rec_ctx, rec_dists, rank_probs,
                 live_count, ctx, *, proposals, top_k, sublens, lc,
                 u_lo=0, span=None):
    """The CUDA kernel; same arguments and results as propose_plain (the
    results are slices of one buffer)."""
    Cn, n = slab.shape
    M = ctx.cand_dist.shape[1]
    NC = 2 + sublens * (4 + M)
    rows = Cn * proposals
    PR = PL.get_layout(lc).PACKED_ROWS
    if not 1 <= top_k <= NC:
        raise ValueError(f"top_k={top_k} outside 1..{NC} candidates")
    if ctx.sparse.shape[0] < max(n - 1, 1).bit_length():
        raise ValueError(f"sparse: {ctx.sparse.shape[0]} rows are too few "
                         f"for LCE queries over {n} positions")
    i64 = torch.int64
    # the per-chain vectors may be views of the repair kernel's outputs:
    # the kernel takes their row strides
    for name, t, shape in (("q", q, (Cn,)), ("rec_ctx", rec_ctx, (Cn,)),
                           ("rec_dists", rec_dists, (Cn, 4)),
                           ("live_count", live_count, (Cn,))):
        cuda_lib.require(t, name, shape, rows=True)
    for name, t, shape, dtype in (
            ("keys", keys, (Cn, 2), i64), ("skey", skey, (2,), i64),
            ("slab", slab, None, torch.int32),
            ("rank_probs", rank_probs, (Cn, PR), torch.int32),
            ("data", ctx.data, (n,), torch.int32),
            ("rank", ctx.rank, (n,), torch.int32),
            ("sparse", ctx.sparse, (None, n), torch.int32),
            ("cand_dist", ctx.cand_dist, (n, M), torch.int32),
            ("cand_len", ctx.cand_len, (n, M), torch.int32),
            ("cand_count", ctx.cand_count, (n,), torch.int32),
            ("corr", ctx.corr, (128,), torch.int32)):
        cuda_lib.require(t, name, shape, dtype)
    # one buffer: key_next and skey_next (int64 words) first, then v0,
    # v1, u, acc_u (float32) and metric
    buf = torch.empty(4 * Cn + 4 + 3 * rows + Cn + rows * NC,
                      dtype=torch.int32, device=slab.device)
    o = 4 * Cn + 4
    key_next = buf[:4 * Cn].view(i64).view(Cn, 2)
    skey_next = buf[4 * Cn:o].view(i64)
    v0, v1, u = buf[o:o + 3 * rows].view(3, rows)
    o += 3 * rows
    acc_u = buf[o:o + Cn].view(torch.float32)
    metric = buf[o + Cn:].view(rows, NC)
    p = cuda_lib.ptr
    with torch.cuda.device(slab.device):
        err = cuda_lib.lib().meg_propose(
            p(keys), p(skey), p(slab), p(q), p(rec_ctx), p(rec_dists),
            p(rank_probs), p(live_count), p(ctx.data), p(ctx.rank),
            p(ctx.sparse), p(ctx.cand_dist), p(ctx.cand_len),
            p(ctx.cand_count), p(ctx.corr), p(key_next), p(skey_next),
            p(v0), p(v1), p(u), p(acc_u), p(metric), Cn, proposals, n, M,
            sublens, top_k, PR, lc, int(span is None), int(u_lo),
            0 if span is None else int(span), q.stride(0), rec_ctx.stride(0),
            rec_dists.stride(0), live_count.stride(0),
            cuda_lib.layout_array(lc).ctypes.data, cuda_lib.stream())
    cuda_lib.check(err, "propose")
    propose_cuda.launches += 1
    return key_next, skey_next, v0, v1, u, acc_u, metric


propose_cuda.launches = 0


def propose(keys, skey, slab, q, rec_ctx, rec_dists, rank_probs,
            live_count, ctx, **kw):
    """Dispatch on the slab's device."""
    fn = propose_cuda if slab.is_cuda else propose_plain
    return fn(keys, skey, slab, q, rec_ctx, rec_dists, rank_probs,
              live_count, ctx, **kw)
