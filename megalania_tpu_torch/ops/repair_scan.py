"""Fused repair + exact-costing pass, plain PyTorch version.

The annealing move's heavy half (reference: the encode-prefix / mutate /
repair-tail walk, src/packet_slab_neighbour.c:82-173) as one walk over
the slab, vectorised over chains:

  * positions < q encode as-is;
  * positions >= q run the repair rules (literal<->short-rep flips by
    rep0 byte equality, long-rep re-aiming against the live rep stack,
    fallback to literal or to the best table match) before encoding;
  * the pass emits the repaired slab (with live bits) as its output, so
    accept/reject is a pure select — no undo stack;
  * at site u it records (ctx, dists, live_pos): the coder state at the
    next mutation site, consumed by the next iteration's proposer.

Partial re-cost: the pass can START from a coder-state snapshot at
`start_pos` (probs_in/carry_in) — positions below pass through verbatim
and contribute their cost via the snapshot's hi/lo — and CAPTURE a
snapshot of the full coder state entering `cap_pos` (cap_pos >= n: the
final state).  The caller guarantees start_pos <= min(q, u) and
cap_pos <= q.

This is the plain version of the CUDA repair kernel (ops/repair_cuda.py)
and the port of megalania_tpu/ops/repair_scan.repair_cost_batched, whose
lax.scan becomes a Python loop over positions.  A stretch of positions
where no chain has a packet start is handled in one vector op (the
reference's dead-tile path), so the loop runs once per position that
starts a packet in at least one chain.  Probabilities are in the flat
layout (ops/tables.py); the dispatcher converts at the packed boundary.
"""
from __future__ import annotations

import torch

from . import bitplan
from . import tables as T
from ..models import lzma_state as S
from ..models import packets as P
from ..utils import fixedpoint as fp

# The [16]-column scalar-carry snapshot layout, shared with the CUDA
# kernel and with megalania_tpu (repair_scan.CARRY16): one int32 column
# per field.
CARRY16 = ("ctx", "d0", "d1", "d2", "d3", "live", "hi", "lo", "since",
           "rctx", "rd0", "rd1", "rd2", "rd3", "rlive", "pord")


def _repair_entry(i, ptype, dist, length, dists, since, data, cd_row,
                  cl_row, n, lrep_fallback):
    """Repair rules for the packets at position i (one per chain) under
    each chain's state; cd_row/cl_row: the [M] candidate-table row at i
    (length 0 marks an empty slot), shared by all chains."""
    d0 = dists[:, 0]
    mb = data[torch.clamp(i - d0 - 1, 0, n - 1)]
    srep_ok = (i > 0) & (d0 + 1 <= i) & (data[i] == mb)
    count_ok = since < 4
    ls_type = torch.where(srep_ok & count_ok, P.SREP,
                          torch.where(srep_ok, ptype, P.LIT))

    # long-rep re-aim: the current index, else the first valid stack
    # slot; valid = the stack distance appears in the candidate row with
    # sufficient extension
    hit4 = ((cd_row == dists[:, :, None])
            & (cl_row >= length[:, None, None])).any(-1)
    valid4 = (dists + 1 <= i) & hit4
    cur_idx = torch.clamp(dist, 0, 3)
    cur_ok = valid4.gather(1, cur_idx[:, None].long())[:, 0]
    first_valid = torch.argmax(valid4.to(torch.int32), dim=1)
    lrep_ok = cur_ok | valid4.any(1)
    lrep_idx = torch.where(cur_ok, cur_idx, first_valid)
    fb_type = torch.where(srep_ok & count_ok, P.SREP, P.LIT)

    is_ls = (ptype == P.LIT) | (ptype == P.SREP)
    is_lrep = ptype == P.LREP
    if lrep_fallback == "match":
        # the longest table match at i, smallest distance on ties
        ml = cl_row.max()
        bd = torch.where(cl_row == ml, cd_row, 2**30).min()
        flen = torch.clamp(ml, max=n - i)
        use_m = is_lrep & ~lrep_ok & (flen >= 2)
    else:
        bd = flen = 0
        use_m = torch.zeros_like(is_lrep)

    new_type = torch.where(
        is_ls, ls_type,
        torch.where(is_lrep,
                    torch.where(lrep_ok, P.LREP,
                                torch.where(use_m, P.MATCH, fb_type)),
                    ptype))
    new_dist = torch.where(
        is_lrep & lrep_ok, lrep_idx,
        torch.where(use_m, bd, torch.where(is_ls | is_lrep, 0, dist)))
    new_len = torch.where(
        use_m, flen,
        torch.where(is_lrep & ~lrep_ok, 1, torch.where(is_ls, 1, length)))
    return (new_type.to(torch.int32), new_dist.to(torch.int32),
            new_len.to(torch.int32))


def carry_to16(ctx, dists, live, hi, lo, since, rctx, rdists, rlive,
               pord) -> torch.Tensor:
    return torch.stack([ctx, dists[:, 0], dists[:, 1], dists[:, 2],
                        dists[:, 3], live, hi, lo, since, rctx,
                        rdists[:, 0], rdists[:, 1], rdists[:, 2],
                        rdists[:, 3], rlive, pord], dim=1).to(torch.int32)


def substitute(slabs, q, mut0, mut1, start_pos: int):
    """The slab the walk reads: mut0/mut1 written at clip(q)/clip(q)+1
    (within the walked region [start_pos, n)), as the kernel substitutes
    them in-stream."""
    C, n = slabs.shape
    mpos = torch.clamp(q, 0, n - 1).long()
    rows = torch.arange(C, device=slabs.device)
    sub = slabs.clone()
    sub[rows, mpos] = torch.where(mpos >= start_pos, mut0.to(torch.int32),
                                  sub[rows, mpos])
    m1pos = torch.clamp(mpos + 1, max=n - 1)
    ok1 = (mpos + 1 < n) & (mpos + 1 >= start_pos)
    sub[rows, m1pos] = torch.where(ok1, mut1.to(torch.int32),
                                   sub[rows, m1pos])
    return sub


def repair_cost_batched(slabs, q, u, data, cand_dist, cand_len, log2,
                        site_mode: str = "byte",
                        lrep_fallback: str = "litsrep",
                        start_pos=None, cap_pos=None,
                        probs_in=None, carry_in=None, lc: int = 0,
                        mut0=None, mut1=None):
    """Run the fused pass for C chains.

    slabs: int32[C, n] packed words; q, u: int32[C];
    data: int32[n]; cand_dist/cand_len: int32[n, M]; log2: int32[2048].
    mut0/mut1 (optional int32[C]): cell values substituted at clip(q)
    and clip(q)+1 while walking (None: the slab is already mutated).
    start_pos/cap_pos: python ints or 0-d tensors (defaults 0 and n);
    probs_in [C, PROBS_PAD] flat + carry_in [C, 16] (see CARRY16).

    Returns (new_slabs [C,n] with live bits, cost_hi[C], cost_lo[C],
    snap_probs [C,PROBS_PAD], rec_ctx[C], rec_dists[C,4], rec_live[C],
    live_count[C], snap_carry [C,16]).
    """
    C, n = slabs.shape
    dev = slabs.device
    start = 0 if start_pos is None else int(start_pos)
    cap = n if cap_pos is None else int(cap_pos)
    if probs_in is None:
        probs = torch.as_tensor(T.init_probs_np(lc=lc), device=dev)
        probs = probs.expand(C, -1).clone()
        c16 = torch.zeros((C, 16), dtype=torch.int32, device=dev)
    else:
        probs = probs_in.clone()
        c16 = carry_in
    ctx, dists, live = c16[:, 0], c16[:, 1:5], c16[:, 5]
    hi, lo, since = c16[:, 6], c16[:, 7], c16[:, 8]
    rctx, rdists, rlive, pord = c16[:, 9], c16[:, 10:14], c16[:, 14], \
        c16[:, 15]
    zero = torch.zeros_like(since)

    src = slabs if mut0 is None else substitute(slabs, q, mut0, mut1, start)
    out = slabs.clone()
    packet_sites = site_mode == "packet"

    def snapshot():
        return probs.clone(), carry_to16(ctx, dists, live, hi, lo, zero,
                                         rctx, rdists, rlive, pord)

    def record(at_u):
        nonlocal rctx, rdists, rlive
        rctx = torch.where(at_u, ctx, rctx)
        rdists = torch.where(at_u[:, None], dists, rdists)
        rlive = torch.where(at_u, live, rlive)

    snap = snapshot() if cap < start else None
    i = start
    while i < n:
        j = min(int(live.min()), n)
        if j > i:
            # dead stretch [i, j): no chain starts a packet here, so the
            # state is constant — clear live bits, record sites inside,
            # capture if the capture point lies inside
            out[:, i:j] = src[:, i:j] & P.NOT_LIVE
            if packet_sites:
                if i <= cap < j:
                    snap = snapshot()
            elif i <= cap < j:
                record((u >= i) & (u < cap))
                snap = snapshot()
                record((u >= cap) & (u < j))
            else:
                record((u >= i) & (u < j))
            i = j
            continue
        if i == cap:
            snap = snapshot()
        active = live == i
        record(active & (pord == u) if packet_sites else u == i)

        entry = src[:, i]
        ptype, dist, length, _ = P.unpack(entry)
        in_repair = active & (i >= q)
        r_type, r_dist, r_len = _repair_entry(
            i, ptype, dist, length, dists, since, data, cand_dist[i],
            cand_len[i], n, lrep_fallback)
        ptype = torch.where(in_repair, r_type, ptype)
        dist = torch.where(in_repair, r_dist, dist)
        length = torch.where(in_repair, r_len, length)

        mb = data[torch.clamp(i - dists[:, 0] - 1, 0, n - 1)]
        prev = data[i - 1] if i > 0 else 0
        plan = bitplan.make_bit_plan(ptype, dist, length, ctx, dists,
                                     data[i], mb, prev_byte=prev, lc=lc)
        plan = plan._replace(
            active=plan.active & active[:, None],
            n_direct=torch.where(active, plan.n_direct, 0))
        cost = bitplan.apply_plan(probs, plan, log2, lc=lc)
        hi, lo = fp.accumulate(hi, lo, cost)

        out[:, i] = torch.where(active, P.pack(ptype, dist, length, live=1),
                                entry & P.NOT_LIVE)
        ctx = torch.where(active, S.ctx_next(ctx, ptype), ctx)
        dists = torch.where(active[:, None],
                            S.dists_next(dists, ptype, dist), dists)
        live = live + torch.where(active, length, 0)
        since = since + in_repair.to(torch.int32)
        pord = pord + active.to(torch.int32)
        i += 1
    if snap is None:                 # cap_pos >= n: the final state
        snap = snapshot()
    return (out, hi, lo, snap[0], rctx, rdists, rlive, pord, snap[1])
