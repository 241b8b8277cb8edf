"""Scale-out over torch.distributed: blocks x chains
(megalania_tpu/parallel/mesh.py).

The world's ranks form b block groups of c chain ranks each.  Blocks are
independent, so block groups never talk to each other until the final
ordered gather of the streams (parallel/multihost.py).  Inside a block
group the block's chains are split over the c ranks, with an exact
best exchange after every iteration: the (hi, lo) best of every rank is
all-gathered, and the n-sized best slab moves only on iterations where
the global best improved, broadcast from the winning rank.  The exchange
runs inside the iteration, before an epoch restart reseeds chains from
the best (megalania_tpu's mesh step exchanges after the iteration, so a
restart there can reseed a shard from a stale best).

The backend follows the device: gloo for cpu tensors, nccl for cuda
(multihost.initialize picks it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..anneal import engine
from ..utils import fixedpoint as fp


@dataclass(frozen=True)
class Mesh:
    blocks: int                 # b: block groups
    chains: int                 # c: chain ranks per block group
    block_group: int            # this rank's block group
    chain_rank: int             # this rank's place in it
    chain_group: Optional[dist.ProcessGroup]   # None without a world


def layout(n_blocks: int, world_size: int) -> tuple[int, int]:
    """(b, c): the most block groups b that divide both the world and
    the block count (the reference's rule), c = world_size // b."""
    b = max(1, min(n_blocks, world_size))
    while world_size % b or n_blocks % b:
        b -= 1
    return b, world_size // b


def make_mesh(n_blocks: int) -> Mesh:
    """The mesh of this process's world (one rank: b = c = 1, no group).
    Every rank calls it with the same n_blocks: it creates one process
    group per block group, collectively."""
    if not dist.is_initialized():
        return Mesh(1, 1, 0, 0, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    b, c = layout(n_blocks, world)
    groups = [dist.new_group(list(range(g * c, (g + 1) * c)))
              for g in range(b)]
    return Mesh(b, c, rank // c, rank % c, groups[rank // c])


def exchange_best(best_slab, best_hi, best_lo, prev_hi, prev_lo, group):
    """The block's exact best after an iteration, on every rank of the
    chain group: -> (best_slab, best_hi, best_lo).

    Before the iteration every rank held the same best (prev_hi,
    prev_lo); a rank's own best (best_*) moved only if one of its chains
    beat it.  So the block's best changed iff the lexicographic (hi, lo)
    argmin over the ranks beats prev; ties go to the lowest rank, which
    holds the lowest global chain ids, as the single-process argmin
    does.  The predicate is computed from all-gathered scalars, so every
    rank takes the same branch, and the slab is broadcast only when it
    holds (otherwise every rank's best already equals prev)."""
    size = dist.get_world_size(group)
    mine = torch.stack([best_hi, best_lo]).to(torch.int32)
    both = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(both, mine, group=group)
    exchange_best.scalar_gathers += 1
    both = torch.stack(both)
    w = fp.argmin(both[:, 0], both[:, 1])
    hi, lo = both[w, 0], both[w, 1]
    if not bool(fp.less(hi, lo, prev_hi, prev_lo)):
        return best_slab, best_hi, best_lo
    best_slab = best_slab.contiguous()
    dist.broadcast(best_slab, src=dist.get_global_rank(group, int(w)),
                   group=group)
    exchange_best.slab_broadcasts += 1
    return best_slab, hi, lo


exchange_best.scalar_gathers = 0
exchange_best.slab_broadcasts = 0


def shard_state(state: engine.AnnealState, rank: int,
                size: int) -> engine.AnnealState:
    """Rank `rank`'s chain rows of a whole block's state (the best and
    the schedule counters are the block's, held by every rank)."""
    C = state.chains.slab.shape[0]
    if C % size:
        raise ValueError(f"{C} chains do not split over {size} ranks")
    Cn = C // size
    return state._replace(chains=engine.ChainState(
        *(t[rank * Cn:(rank + 1) * Cn].contiguous() for t in state.chains)))


def gather_state(state_shard: engine.AnnealState,
                 group) -> engine.AnnealState:
    """The whole block's state from its chain ranks' shards (collective
    over the chain group; every rank gets it)."""
    size = dist.get_world_size(group)
    fields = []
    for t in state_shard.chains:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        fields.append(torch.cat(parts))
    return state_shard._replace(chains=engine.ChainState(*fields))
