"""Proposal generation: one annealing move per chain, batched over chains.

Mirrors the reference move distribution
(src/packet_slab_neighbour.c:119-152):

  * with p=1/2, a boundary move — shift one byte between a 1-byte packet
    and an adjacent match (shrink head / grow into predecessor);
  * otherwise (or when no boundary applies) a biased sample from the
    top-K next packets by amortized bit cost (cost/len, integer division
    as in top_k_packet_finder.c:115), choice = max of `bias_draws`
    uniforms with a forced-best escape, matching neighbour.c:56-72.

Candidates come from the precomputed dense Pareto table plus rep-stack
LCE probes, and are *ranked* under the chain's snapshot probability
state (ops/propose_cuda.py).  The ranking is a proposal heuristic only —
acceptance always uses the exact cost from the repair pass.

Port of megalania_tpu/anneal/moves.py: where the reference vmaps one
chain, every function here takes a leading chain axis C.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..match.suffix import lce
from ..models import packets as P
from ..ops import propose_cuda, tables as T
from ..utils import threefry as R

SUBLENS = 3  # default lengths per (dist, maxlen) entry: m, m*2//3, 2
BIG = 2 ** 30


def _sublens(maxlen, k: int = SUBLENS):
    """[..., k] candidate lengths for each entry, and their keep mask
    (duplicates of an earlier length masked).  k=3 gives {m, 2m/3, 2}."""
    m = maxlen
    two = torch.full_like(m, 2)
    gens = [
        m,
        torch.maximum((m * 2) // 3, two),
        two,
        torch.maximum(m - 1, two),
        torch.maximum(m - 2, two),
        torch.maximum((m * 3) // 4, two),
        torch.maximum(m // 2, two),
        torch.maximum(m // 3, two),
        torch.maximum(m - 3, two),
        torch.full_like(m, 3),
    ]
    assert k <= len(gens), k
    lens = torch.stack(gens[:k])
    keep = [torch.ones_like(m, dtype=torch.bool)]
    for j in range(1, k):
        uniq = torch.ones_like(m, dtype=torch.bool)
        for jj in range(j):
            uniq = uniq & (lens[j] != lens[jj])
        keep.append(uniq)
    return lens, torch.stack(keep)


class Candidates(NamedTuple):
    ptype: torch.Tensor   # int32[C, NC]
    dist: torch.Tensor    # int32[C, NC]
    length: torch.Tensor  # int32[C, NC]
    valid: torch.Tensor   # bool[C, NC]


def gather_candidates(q, rec_dists, data, rank, sparse, cand_dist, cand_len,
                      cand_count, sublens: int = SUBLENS) -> Candidates:
    """Candidate set at sites q [C] (cf. packet_enumerator.c:57-74):
    1 literal + 1 short rep + SL x 4 long reps + SL x M table matches."""
    n = data.shape[0]
    C = q.shape[0]
    M = cand_dist.shape[1]
    SL = sublens
    i32 = torch.int32
    dev = q.device

    def col(v):
        return torch.full((C, 1), v, dtype=i32, device=dev)

    # short rep: byte equality at rep0
    d0 = rec_dists[:, 0]
    mb = data[torch.clamp(q - d0 - 1, 0, n - 1)]
    v_srep = (q > 0) & (q >= d0 + 1) & (data[torch.clamp(q, 0, n - 1)] == mb)

    # long reps: for each stack slot, extension via LCE
    src = torch.clamp(q[:, None] - rec_dists - 1, 0, n - 1)
    in_range = rec_dists + 1 <= q[:, None]
    ext4 = torch.clamp(lce(rank, sparse, n, q[:, None].expand(C, 4), src),
                       max=T.MATCH_LEN_MAX)
    ext4 = torch.where(in_range, ext4, 0)
    lens4, keep4 = _sublens(ext4, SL)              # [SL, C, 4]
    v_lrep = keep4 & (ext4 >= T.MATCH_LEN_MIN) & (lens4 <= ext4)
    d_lrep = torch.arange(4, dtype=i32, device=dev).expand(SL, C, 4)

    # matches from the Pareto table
    qi = q.long()
    row_d = cand_dist[qi]                          # [C, M]
    row_l = cand_len[qi]
    row_valid = torch.arange(M, device=dev) < cand_count[qi][:, None]
    lensM, keepM = _sublens(row_l, SL)             # [SL, C, M]
    v_m = (keepM & row_valid & (lensM >= T.MATCH_LEN_MIN)
           & (lensM <= row_l))

    def flat(x):                                   # [SL, C, K] -> [C, SL*K]
        return x.permute(1, 0, 2).reshape(C, -1)

    ptype = torch.cat([col(P.LIT), col(P.SREP), col(P.LREP).expand(C, SL * 4),
                       col(P.MATCH).expand(C, SL * M)], dim=1)
    dist = torch.cat([col(0), col(0), flat(d_lrep),
                      flat(row_d.expand(SL, C, M))], dim=1)
    length = torch.cat([col(1), col(1), flat(lens4), flat(lensM)], dim=1)
    valid = torch.cat([torch.ones((C, 1), dtype=torch.bool, device=dev),
                       v_srep[:, None], flat(v_lrep), flat(v_m)], dim=1)
    return Candidates(ptype, dist.to(i32), length.to(i32), valid)


def enumerate_candidates(slab, q, rec_dists, data, rank, sparse,
                         cand_dist, cand_len, cand_count,
                         sublens: int = SUBLENS) -> Candidates:
    """Candidate sets at the (clipped) sites, minus each incumbent packet.
    Pure enumeration — no probability reads."""
    n = data.shape[0]
    qc = torch.clamp(q, 0, n - 1)
    cur_t, cur_d, cur_l, _ = P.unpack(slab.gather(1, qc[:, None].long()))
    cands = gather_candidates(qc, rec_dists, data, rank, sparse, cand_dist,
                              cand_len, cand_count, sublens=sublens)
    same_as_cur = ((cands.ptype == cur_t) & (cands.dist == cur_d)
                   & (cands.length == cur_l))
    return cands._replace(valid=cands.valid & ~same_as_cur)


def pack_candidates(cands: Candidates) -> torch.Tensor:
    """Candidates as packed words, live bit = valid (the rank kernel's
    input format)."""
    return P.pack(cands.ptype, cands.dist, cands.length, cands.valid)


def site_bytes(data, q, rec_dists):
    """The rank kernel's per-chain byte context at the clipped sites q:
    (data byte, byte one rep0-distance back, previous byte), int32 [C]."""
    n = data.shape[0]
    qc = torch.clamp(q, 0, n - 1).long()
    mb = data[torch.clamp(qc - rec_dists[:, 0] - 1, 0, n - 1)]
    prev = torch.where(qc > 0, data[torch.clamp(qc - 1, min=0)], 0)
    return data[qc], mb, prev.to(torch.int32)


def rank_candidates(cands: Candidates, rank_probs, rec_ctx, rec_dists,
                    byte, match_byte, prev_byte, lc: int = 0):
    """Amortized bit cost (cost // len) per candidate [C, NC] under the
    ranking state (class-packed rank_probs); BIG where invalid.  The
    plain ranking of the proposal kernel (ops/propose_cuda.rank_plain)."""
    return propose_cuda.rank_plain(rank_probs, pack_candidates(cands),
                                   rec_ctx, rec_dists, byte, match_byte,
                                   prev_byte, lc=lc)


def biased_topk_choice(metric, valid, k, key, bias_draws=8,
                       force_best_prob=0.125):
    """Reference sampling rule over the K cheapest candidates, per chain.

    Ties break toward the lower index, like lax.top_k: a stable ascending
    sort.  Returns (index into the candidate axis [C], any valid [C])."""
    idx = torch.sort(metric, dim=1, stable=True).indices[:, :k]
    count = torch.clamp(valid.sum(1), max=k).to(torch.int32)
    ks = R.split(key, 2)
    draws = R.randint(ks[:, 0], (bias_draws,), 0,
                      torch.clamp(count, min=1)[:, None])
    choice = draws.max(1).values
    forced = R.uniform(ks[:, 1]) < force_best_prob
    choice = torch.where(forced, count - 1, choice)
    sel = torch.clamp(count - 1 - choice, 0, k - 1)
    return idx.gather(1, sel[:, None].long())[:, 0], count > 0


def select_mutation(slab, q, rec_dists, cands: Candidates, metric, key,
                    data, top_k=20):
    """Boundary move or biased top-K resample; returns the two mutated
    cell values (v0 at qc, v1 at qc+1) [C] WITHOUT writing the slab — the
    repair pass substitutes them while it walks.  At qc == n-1 the
    reference's second write lands on the same cell, so v0 = v1 there."""
    n = data.shape[0]
    qc = torch.clamp(q, 0, n - 1).long()
    q1 = torch.clamp(qc + 1, max=n - 1)
    cell0 = slab.gather(1, qc[:, None])[:, 0]
    cell1 = slab.gather(1, q1[:, None])[:, 0]
    cur_t, cur_d, cur_l, _ = P.unpack(cell0)

    ks = R.split(key, 2)
    coin = R.uniform(ks[:, 0]) < 0.5

    # ---- boundary moves (neighbour.c:122-146) -------------------------
    has_next = qc + 1 < n
    nxt_t, nxt_d, nxt_l, _ = P.unpack(cell1)
    first_is_match = (cur_t == P.MATCH) | (cur_t == P.LREP)
    shrink_ok = has_next & first_is_match & (cur_l > 2)

    second_is_match = (nxt_t == P.MATCH) | (nxt_t == P.LREP)
    sec_dist_resolved = torch.where(
        nxt_t == P.LREP,
        rec_dists.gather(1, torch.clamp(nxt_d, 0, 3)[:, None].long())[:, 0],
        nxt_d)
    rep_start = qc - sec_dist_resolved
    grow_ok = (
        has_next
        & ((cur_t == P.LIT) | (cur_t == P.SREP))
        & second_is_match
        & (nxt_l < T.MATCH_LEN_MAX)
        & (rep_start > 0)
        & (data[qc] == data[torch.clamp(rep_start - 1, 0, n - 1)])
    )
    do_shrink = coin & shrink_ok
    do_grow = coin & ~shrink_ok & grow_ok

    # ---- top-K resample ------------------------------------------------
    sel, any_valid = biased_topk_choice(metric, cands.valid, top_k, ks[:, 1])
    pick = sel[:, None]
    sel_t = cands.ptype.gather(1, pick)[:, 0]
    sel_d = cands.dist.gather(1, pick)[:, 0]
    sel_l = cands.length.gather(1, pick)[:, 0]

    # ---- the two mutated cells -----------------------------------------
    new_q = torch.where(
        do_shrink, P.pack(P.LIT, 0, 1),
        torch.where(do_grow, P.pack(nxt_t, nxt_d, nxt_l + 1),
                    torch.where(any_valid, P.pack(sel_t, sel_d, sel_l),
                                cell0)))
    new_q1 = torch.where(do_shrink, P.pack(cur_t, cur_d, cur_l - 1), cell1)
    v0 = torch.where(has_next, new_q, new_q1)
    return v0, new_q1
