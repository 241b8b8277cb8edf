"""Chain-parallel annealing engine.

The reference anneals one chain serially: 3 steps x 200 epoch-restarts x
n moves, one full-file re-encode per move (src/main.c:66-105).  Here C
chains run the same Markov process in lockstep — epochs become the chain
axis — with a shared global best updated by exact argmin every iteration
and epoch restarts that reseed every chain from the best parse (steps
1-2) or from the initial parse (step 0).

One iteration: the proposal stage (proposal kernel: the key schedule,
candidate enumeration and ranking, the mutation choice, the site and
acceptance draws), the fused repair+cost pass (repair kernel) with the
two mutated cells substituted in-pass, acceptance (the reference's
cooling rule, main.c:86), best tracking, restarts.  Port of
megalania_tpu/anneal/engine.py; `run_iters` is a Python loop.  Under a
torch profiler five spans (utils/profiling.span) tile each iteration
in order: iter.draw (the proposal stage and what sets it up), iter.cost
(the repair pass), iter.accept, iter.best (with the group's exchange)
and iter.restart (the epoch restart and the sweep bookkeeping).

Device: every tensor of a BlockContext and an AnnealState lives on
`ctx.device`, chosen by the caller.  On cuda the kernels run; on cpu
their plain versions.  There is no other switch.  The schedule counters
the host decides on (it_in_epoch, epochs_done, moves_done, sweep_j,
u_prev) are Python ints; snap_pos is a 0-d device tensor (it depends on
the chains' sites), read by the repair kernel on the device.

Chain sharding: with a torch.distributed process group (`group`), rank r
of the group holds rows r*Cn .. (r+1)*Cn-1 of the single-process state
(Cn = C / group size), bit for bit.  Chain identity is global (the
mixed acceptance and init splits), the snapshot position is the minimum
over the whole block, the best parse is exchanged across the group every
iteration before an epoch restart reseeds from it (parallel/mesh.py),
and moves_done counts the whole block.  Without a group there is no
collective.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..match import candidates as C_
from ..match import optparse
from ..models import packets as P
from ..ops import log2_cuda, problayout, propose_cuda, repair_cuda
from ..ops import tables as T
from ..utils import fixedpoint as fp
from ..utils import threefry as R
from ..utils.profiling import span
from .config import AnnealConfig


class BlockContext(NamedTuple):
    """Per-block read-only tensors, shared by all chains."""
    data: torch.Tensor        # int32[n]
    data_u8: torch.Tensor     # uint8[n] the same bytes (repair kernel)
    rank: torch.Tensor        # int32[n]
    sparse: torch.Tensor      # int32[K, n]
    cand_dist: torch.Tensor   # int32[n, M]
    cand_len: torch.Tensor    # int32[n, M]
    cand_count: torch.Tensor  # int32[n]
    log2: torch.Tensor        # int32[2048] exact cost table
    corr: torch.Tensor        # int32[128] log2 correction (proposal kernel)
    f2p: torch.Tensor         # int32[PROBS_PAD] flat->packed slot map
    init_slab: torch.Tensor   # int32[n] initial parse (cfg.init)
    device: torch.device


class ChainState(NamedTuple):
    slab: torch.Tensor        # int32[C, n] packed words
    cost_hi: torch.Tensor     # int32[C]
    cost_lo: torch.Tensor     # int32[C]
    rank_probs: torch.Tensor  # int32[C, PACKED_ROWS] snapshot probs
    rec_ctx: torch.Tensor     # int32[C]
    rec_dists: torch.Tensor   # int32[C, 4]
    rec_live: torch.Tensor    # int32[C]
    live_count: torch.Tensor  # int32[C]
    key: torch.Tensor         # int64[C, 2] threefry keys (uint32 words)
    snap_carry: torch.Tensor  # int32[C, 16] (repair_scan.CARRY16)


class AnnealState(NamedTuple):
    chains: ChainState
    best_slab: torch.Tensor   # int32[n]
    best_hi: torch.Tensor     # int32 0-d
    best_lo: torch.Tensor     # int32 0-d
    it_in_epoch: int          # shared cooling clock
    epochs_done: int
    moves_done: int           # accepted+rejected, all chains
    sweep_j: int              # stratum index; 0 = fresh full walk
    snap_pos: torch.Tensor    # int32 0-d: position of the held snapshot
    u_prev: int               # last stratum base
    skey: torch.Tensor        # int64[2] key for shared (per-block) draws


MAX_TILE = 2048


def choose_tile(n: int, cb: int = 128, lc: int = 0) -> int:
    """Positions per sweep tile (megalania_tpu/ops/pallas_repair2.py
    choose_tile, verbatim): the sweep strata and the snapshot positions
    are multiples of it, so it is part of the trajectory.  The rule was
    sized for the TPU kernel's grid; the port keeps its values so that
    one seed gives the same bytes in both packages."""
    env = os.environ.get("MEGALANIA_TILE")
    if env:                       # perf-probe / tuning override
        return max(1, min(int(env), MAX_TILE, n))

    def grow(budget: int) -> int:
        probs = 3 * problayout.get_layout(lc).PACKED_ROWS * cb * 4
        t = 256
        while t < MAX_TILE and t * 16 < n:
            t2 = t * 2
            if probs + t2 * 16 * (cb + 16) > budget:
                break
            t = t2
        return t
    t = grow(14 << 20)           # the reference's default VMEM budget
    if -(-n // t) > 64:
        t = max(t, grow(15500 << 10))
    return max(1, min(t, MAX_TILE, n))


def effective_schedule(cfg: AnnealConfig) -> str:
    """Packet-ordinal sites have no byte position to sweep, so they force
    the "random" full-walk schedule."""
    return "random" if cfg.site_mode == "packet" else cfg.site_schedule


def make_context(data: bytes, cfg: AnnealConfig, device) -> BlockContext:
    """Block preprocessing (LCE index, candidate tables, initial parse)
    and the device's log2 correction; tensors on `device`.  The index is
    built on the host and uploaded once (candidates.block_index); the
    candidate tables are built on `device` (the kernel on cuda).  The
    index and the annealer's candidate table run in the profiler span
    context.index; the initial parse is optparse.seed_slab's."""
    device = torch.device(device)
    arr = np.frombuffer(bytes(data), np.uint8)
    with span("context.index"):
        idx = C_.block_index(arr, device)
        tab = C_.candidate_table(arr, cfg.max_candidates, cfg.max_walk, idx)
    init_slab, _ = optparse.seed_slab(arr, cfg, index=idx, table=tab)
    return _block_context(arr, idx.rank, idx.sparse, tab, init_slab, cfg.lc,
                          device)


def context_from_numpy(*, data, rank, sparse, cand_dist, cand_len,
                       cand_count, init_slab, lc: int = 0,
                       device="cuda") -> BlockContext:
    """A BlockContext on `device` from the reference's BlockContext
    fields as numpy arrays (init_slab as uint32).  The log2 correction is
    always built by `device`'s own float32 path (one kernel launch on
    cuda)."""
    device = torch.device(device)
    return _block_context(
        data, _i32(rank, device), _i32(sparse, device),
        C_.CandidateTable(*(_i32(a, device)
                            for a in (cand_dist, cand_len, cand_count))),
        init_slab, lc, device)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32), device=device)


def _block_context(data, rank, sparse, tab, init_slab, lc: int,
                   device) -> BlockContext:
    """The BlockContext of the bytes `data` (numpy), with the index and
    the candidate table already on `device`, and init_slab (uint32)."""
    log2 = _i32(T.LOG2_TABLE_I32, device)
    return BlockContext(
        data=_i32(data, device),
        data_u8=torch.as_tensor(np.array(data, np.uint8), device=device),
        rank=rank, sparse=sparse, cand_dist=tab.dist, cand_len=tab.length,
        cand_count=tab.count, log2=log2,
        corr=log2_cuda.log2_correction(log2),
        f2p=_i32(problayout.get_layout(lc).F2P_PAD, device),
        init_slab=P.from_u32(init_slab, device), device=device)


def _repair_cost(slabs, q, u, ctx: BlockContext, cfg: AnnealConfig, **kw):
    return repair_cuda.repair_cost(
        slabs, q, u, ctx.data, ctx.data_u8, ctx.cand_dist, ctx.cand_len,
        ctx.log2, site_mode=cfg.site_mode, lrep_fallback=cfg.lrep_fallback,
        lc=cfg.lc, **kw)


def chain_shard(group):
    """(rank, size) of this process in the chain group; (0, 1) alone."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _init_rows(ctx: BlockContext, cfg: AnnealConfig, C: int,
               offset: int = 0):
    """[C, n] initial slabs of global chains offset .. offset+C-1:
    init_slab, or under mixed/mixed_opt a period-8 split with all-literal
    rows (cfg.mixed_greedy_frac) keyed on the global chain id."""
    n = ctx.data.shape[0]
    rows = ctx.init_slab.expand(C, n)
    if cfg.init in ("mixed", "mixed_opt"):
        lit = P.from_u32(P.literal_slab(n), ctx.device)
        g8 = max(0, min(8, round(cfg.mixed_greedy_frac * 8)))
        gid = torch.arange(C, device=ctx.device) + offset
        use_lit = ((gid * g8 % 8) >= g8)
        rows = torch.where(use_lit[:, None], lit, rows)
    return rows.contiguous()


def init_state(ctx: BlockContext, cfg: AnnealConfig,
               group=None) -> AnnealState:
    """Fresh chains on the initial parse, costed once (a full walk).
    With a chain group: this rank's rows, and the best of global chain 0
    (held by the group's rank 0) broadcast to every rank.  Runs in the
    profiler span init_state."""
    with span("init_state"):
        return _init_state(ctx, cfg, group)


def _init_state(ctx: BlockContext, cfg: AnnealConfig,
                group=None) -> AnnealState:
    n = ctx.data.shape[0]
    C = cfg.chains
    rank, size = chain_shard(group)
    if C % size:
        raise ValueError(f"{C} chains do not split over {size} ranks")
    Cn, off = C // size, rank * (C // size)
    dev = ctx.device
    all_keys = R.split(R.PRNGKey(cfg.seed, dev), C + 1)
    keys, skey = all_keys[off:off + Cn], all_keys[C]
    ks = R.split(keys, 2)
    u = R.randint(ks[:, 1], (), 0, n)
    slabs, hi, lo, probs, rctx, rdists, rlive, count, snapc = _repair_cost(
        _init_rows(ctx, cfg, Cn, off),
        torch.full((Cn,), n, dtype=torch.int32, device=dev), u, ctx, cfg)
    chains = ChainState(
        slab=slabs, cost_hi=hi, cost_lo=lo, rank_probs=probs, rec_ctx=rctx,
        rec_dists=rdists, rec_live=rlive, live_count=count,
        key=ks[:, 0].contiguous(), snap_carry=snapc)
    best_slab, best = slabs[0].clone(), torch.stack([hi[0], lo[0]])
    if group is not None:
        src = dist.get_global_rank(group, 0)
        dist.broadcast(best_slab, src=src, group=group)
        dist.broadcast(best, src=src, group=group)
    return AnnealState(
        chains=chains, best_slab=best_slab, best_hi=best[0],
        best_lo=best[1],
        it_in_epoch=0, epochs_done=0, moves_done=0, sweep_j=0,
        snap_pos=torch.zeros((), dtype=torch.int32, device=dev), u_prev=0,
        skey=skey)


def _p_trans(cfg: AnnealConfig, n: int, it_in_epoch: int, step: int):
    """The cooled acceptance probability, in float32 with the reference's
    operation order: sqrt(iters) / (i*i + 1 + step*iters*0.5)."""
    f32 = torch.float32
    iters = torch.tensor(cfg.iters(n), dtype=f32)
    i_f = torch.tensor(it_in_epoch, dtype=f32)
    denom = i_f * i_f + torch.tensor(1.0, dtype=f32) \
        + torch.tensor(step, dtype=f32) * iters * torch.tensor(0.5, dtype=f32)
    return torch.sqrt(iters) / denom


def _chains_iter(state: AnnealState, ctx: BlockContext, step: int,
                 cfg: AnnealConfig, group):
    """One lockstep move for all C chains (each evaluating cfg.proposals
    proposals and keeping the exact best of them).  Under the sweep
    schedule the pass is a PARTIAL re-cost from the previous pass's
    snapshot, recording at a shared, tile-stratified low-to-high site.

    Returns (ChainState, skey_next, stratum_base, cap_pos)."""
    with span("iter.draw"):
        chains = state.chains
        n = ctx.data.shape[0]
        Cn = chains.slab.shape[0]
        Pn = cfg.proposals
        dev = ctx.device
        i32 = torch.int32
        sched = effective_schedule(cfg)

        if sched == "sweep":
            tile = choose_tile(n, cfg.chain_block, cfg.lc)
            j = state.sweep_j
            fresh_sweep = j == 0
            start_pos = (torch.zeros((), dtype=i32, device=dev) if fresh_sweep
                         else state.snap_pos)
            stratum = min((j // cfg.sweep_repeats) * tile, n - 1)
            width = max(min(tile, n - stratum), 1)
            u_min = stratum
            if fresh_sweep:
                probs_c = torch.full_like(chains.rank_probs, T.PROB_INIT)
                carry_c = torch.zeros_like(chains.snap_carry)
            else:
                probs_c, carry_c = chains.rank_probs, chains.snap_carry
            base_carry = carry_c
        else:
            start_pos = None                 # full walk
            u_min = 0
            probs_c = carry_c = None
            base_carry = torch.zeros((Cn, 16), dtype=i32, device=dev)

        # a fresh chain mutates at the snapshot's live position (carry slot
        # 5), not the tile-aligned start: the snapshot boundary can fall
        # mid-packet, and a dead-cell site would be skipped by the walk
        fresh = chains.rec_live >= n
        q = torch.where(fresh, base_carry[:, 5], chains.rec_live)
        rec_ctx = torch.where(fresh, base_carry[:, 0], chains.rec_ctx)
        rec_dists = torch.where(fresh[:, None], base_carry[:, 1:5],
                                chains.rec_dists)

        if sched == "sweep":
            # capture at the highest tile boundary valid for every chain of
            # the block (all ranks of a chain group): <= every mutation site
            # and <= every recording site
            qmin = q.min()
            if group is not None:
                dist.all_reduce(qmin, op=dist.ReduceOp.MIN, group=group)
            cap_pos = torch.clamp(qmin, max=u_min)
            cap_pos = torch.maximum(cap_pos // tile * tile, start_pos).to(i32)
        else:
            cap_pos = None                   # capture the final state

        # the proposal stage, one call: the key schedule, the candidates and
        # their ranking, the two mutated cells of every row (chain-major,
        # cfg.proposals per chain), each row's recording site (under the
        # sweep its own site inside the shared stratum) and each chain's
        # acceptance uniform
        if sched == "sweep":
            site = dict(u_lo=stratum, span=width)
        else:
            site = dict(span=None if cfg.site_mode == "packet" else n)
        key_next, skey_next, mut0, mut1, u, acc_u, _ = propose_cuda.propose(
            chains.key, state.skey, chains.slab, q, rec_ctx, rec_dists,
            chains.rank_probs, chains.live_count, ctx, proposals=Pn,
            top_k=cfg.top_k, sublens=cfg.sublens, lc=cfg.lc, **site)

    with span("iter.cost"):
        if Pn > 1:
            def rep(x):
                return None if x is None else torch.repeat_interleave(x, Pn, 0)
            slab_in, q_in = rep(chains.slab), rep(q)
            probs_snap, carry_snap = rep(probs_c), rep(carry_c)
        else:
            slab_in, q_in = chains.slab, q
            probs_snap, carry_snap = probs_c, carry_c
        (new_slab, hi, lo, probs, rctx, rdists, rlive, count,
         snapc) = _repair_cost(slab_in, q_in, u, ctx, cfg, mut0=mut0,
                               mut1=mut1, start_pos=start_pos, cap_pos=cap_pos,
                               probs_in=probs_snap, carry_in=carry_snap)

    with span("iter.accept"):
        if Pn > 1:
            # exact lexicographic best-of-P per chain (first index on ties)
            hi2, lo2 = hi.reshape(Cn, Pn), lo.reshape(Cn, Pn)
            mh = hi2.min(1, keepdim=True).values
            w = torch.argmin(torch.where(hi2 == mh, lo2, int(fp.INF_HI)), 1)
            rows = torch.arange(Cn, device=dev) * Pn + w

            def sel(x):
                return x[rows]
            new_slab, hi, lo, probs, rctx, rdists, rlive, count, snapc = (
                sel(new_slab), sel(hi), sel(lo), sel(probs), sel(rctx),
                sel(rdists), sel(rlive), sel(count), sel(snapc))

        # acceptance: first / better / cooled transition (main.c:86);
        # "greedy" zeroes the exploratory transition, "mixed" keeps it on
        # even global chain ids only
        if cfg.accept == "greedy":
            p_trans = torch.tensor(0.0, dtype=torch.float32)
        else:
            p_trans = _p_trans(cfg, n, state.it_in_epoch, step)
        trans = acc_u < float(p_trans)        # the float32 value, exactly
        if cfg.accept == "mixed":
            gid = torch.arange(Cn, device=dev) + chain_shard(group)[0] * Cn
            trans = trans & (gid % 2 == 0)
        first = chains.cost_hi == int(fp.INF_HI)
        better = fp.less(hi, lo, chains.cost_hi, chains.cost_lo)
        accept = first | better | trans

        new_chains = ChainState(
            slab=torch.where(accept[:, None], new_slab, chains.slab),
            cost_hi=torch.where(accept, hi, chains.cost_hi),
            cost_lo=torch.where(accept, lo, chains.cost_lo),
            rank_probs=probs, rec_ctx=rctx, rec_dists=rdists, rec_live=rlive,
            live_count=count, key=key_next, snap_carry=snapc)
        cap_out = (cap_pos if cap_pos is not None
                   else torch.zeros((), dtype=i32, device=dev))
    return new_chains, skey_next, u_min, cap_out


def anneal_iteration(state: AnnealState, ctx: BlockContext,
                     cfg: AnnealConfig, group=None) -> AnnealState:
    """One lockstep move across all chains + best/restart bookkeeping.
    With a chain group the best is the block's, exchanged across the
    group before a restart can reseed from it."""
    n = ctx.data.shape[0]
    iters = cfg.iters(n)
    sched = effective_schedule(cfg)
    i32 = torch.int32
    # serial epochs folded onto the chain axis; an init race spans >= 2
    # epochs in step 0 so the losing start survives the first restart
    min_eps = 2 if cfg.init in ("mixed", "mixed_opt") else 1
    epochs_per_step = max(min_eps, -(-cfg.num_epochs // cfg.chains))
    step = min(state.epochs_done // epochs_per_step, cfg.num_steps - 1)

    chains, skey_next, u_base, cap_pos = _chains_iter(state, ctx, step, cfg,
                                                      group)
    with span("iter.best"):
        rank, size = chain_shard(group)

        # global best (reference keeps one best slab, main.c:89-92), read
        # by index_select so that the host does not wait for the device
        b = fp.argmin(chains.cost_hi, chains.cost_lo).reshape(1)
        cand_hi = chains.cost_hi.index_select(0, b)[0]
        cand_lo = chains.cost_lo.index_select(0, b)[0]
        improved = fp.less(cand_hi, cand_lo, state.best_hi, state.best_lo)
        best_slab = torch.where(improved, chains.slab.index_select(0, b)[0],
                                state.best_slab)
        best_hi = torch.where(improved, cand_hi, state.best_hi)
        best_lo = torch.where(improved, cand_lo, state.best_lo)
        if group is not None:
            from ..parallel import mesh
            best_slab, best_hi, best_lo = mesh.exchange_best(
                best_slab, best_hi, best_lo, state.best_hi, state.best_lo,
                group)

    with span("iter.restart"):
        # epoch restart (main.c:70-77): step 0 from the initial parse, else
        # from the best
        it = state.it_in_epoch + 1
        restart = it >= iters
        if restart:
            Cn = chains.slab.shape[0]
            next_step = min((state.epochs_done + 1) // epochs_per_step,
                            cfg.num_steps - 1)
            reseed = (_init_rows(ctx, cfg, Cn, rank * Cn) if next_step == 0
                      else best_slab.expand(Cn, n).contiguous())
            zeros = torch.zeros_like(chains.rec_live)
            chains = chains._replace(
                slab=reseed,
                cost_hi=torch.full_like(chains.cost_hi, int(fp.INF_HI)),
                cost_lo=zeros, rec_ctx=zeros,
                rec_dists=torch.zeros_like(chains.rec_dists), rec_live=zeros)
        # sweep bookkeeping: advance the stratum; a wrap or an epoch restart
        # resets to the fresh full-walk stratum 0
        if sched == "sweep":
            tile = choose_tile(n, cfg.chain_block, cfg.lc)
            sweep_len = -(-n // tile) * cfg.sweep_repeats
            j_next = state.sweep_j + 1
            j_next = 0 if (j_next >= sweep_len or restart) else j_next
        else:
            j_next = 0
        return AnnealState(
            chains=chains, best_slab=best_slab, best_hi=best_hi.to(i32),
            best_lo=best_lo.to(i32), it_in_epoch=0 if restart else it,
            epochs_done=state.epochs_done + int(restart),
            # the block's moves: every rank of a chain group counts them all
            moves_done=state.moves_done
            + chains.slab.shape[0] * cfg.proposals * size,
            sweep_j=j_next, snap_pos=cap_pos, u_prev=u_base, skey=skey_next)


def run_iters(state: AnnealState, ctx: BlockContext, cfg: AnnealConfig,
              n_iters: int, group=None) -> AnnealState:
    """n_iters lockstep iterations (of this rank's chains, with a chain
    group)."""
    with torch.inference_mode():
        for _ in range(n_iters):
            state = anneal_iteration(state, ctx, cfg, group)
    return state


def best_cost_bytes(state: AnnealState) -> float:
    """Predicted output size in bytes (header 13 + flush 5 + entropy)."""
    return 18 + fp.to_int(state.best_hi, state.best_lo) / 16384.0


# ---------------------------------------------------------------------------
# State exchange with the reference (numpy in, numpy out)
# ---------------------------------------------------------------------------

_CHAIN_FIELDS = ChainState._fields
_SCALARS = ("it_in_epoch", "epochs_done", "moves_done", "sweep_j", "u_prev")


def state_from_numpy(st: dict, device) -> AnnealState:
    """An AnnealState on `device` from the reference's AnnealState fields
    as numpy arrays: st[name] for the top-level fields, st["chains"][name]
    for the chain fields (uint32 slabs and PRNG keys as in the
    reference)."""
    device = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    def key(a):
        return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64),
                               device=device)
    ch = st["chains"]
    chains = ChainState(**{
        f: (P.from_u32(ch[f], device) if f == "slab"
            else key(ch[f]) if f == "key" else i32(ch[f]))
        for f in _CHAIN_FIELDS})
    return AnnealState(
        chains=chains, best_slab=P.from_u32(st["best_slab"], device),
        best_hi=i32(st["best_hi"]), best_lo=i32(st["best_lo"]),
        snap_pos=i32(st["snap_pos"]), skey=key(st["skey"]),
        **{f: int(st[f]) for f in _SCALARS})


def state_to_numpy(state: AnnealState) -> dict:
    """The reverse of state_from_numpy: the reference's dtypes (uint32
    slabs and keys, int32 everything else)."""
    def np_(t):
        return t.detach().cpu().numpy()
    ch = state.chains
    chains = {f: (P.to_u32(getattr(ch, f)) if f == "slab"
                  else np_(ch.key).astype(np.uint32) if f == "key"
                  else np_(getattr(ch, f)).astype(np.int32))
              for f in _CHAIN_FIELDS}
    out = {"chains": chains, "best_slab": P.to_u32(state.best_slab),
           "best_hi": np.int32(state.best_hi.item()),
           "best_lo": np.int32(state.best_lo.item()),
           "snap_pos": np.int32(state.snap_pos.item()),
           "skey": np_(state.skey).astype(np.uint32)}
    out.update({f: np.int32(getattr(state, f)) for f in _SCALARS})
    return out
