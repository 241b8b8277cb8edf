"""LZMA coder-state transitions on tensors.

The compressor state (reference: src/lzma_state.h:64-74) is a probability
vector, a ctx-state 0..11 and a rep-distance stack of 4 (stored as
distance-1).  Transitions re-derive src/lzma_state.c:29-81 as
elementwise selects, batched over any leading axes.
"""
from __future__ import annotations

import torch

from . import packets as P


def ctx_next(ctx, ptype):
    """Next ctx-state after encoding a packet of `ptype`: literal cools
    the state toward 0, match/srep/lrep jump to their post-states."""
    lit = torch.where(ctx < 4, 0, torch.where(ctx < 10, ctx - 3, ctx - 6))
    mat = torch.where(ctx < 7, 7, 10)
    sr = torch.where(ctx < 7, 9, 11)
    lr = torch.where(ctx < 7, 8, 11)
    out = torch.where(
        ptype == P.LIT, lit,
        torch.where(ptype == P.MATCH, mat,
                    torch.where(ptype == P.SREP, sr, lr)))
    return out.to(ctx.dtype)


def dists_next(dists, ptype, dist_field):
    """Rep-distance stack update ([..., 4] stack, [...] fields).

    MATCH pushes the explicit distance; LREP promotes stack entry
    `dist_field` to the front (entries above it shift down); LIT/SREP
    leave the stack unchanged."""
    pushed = torch.cat([dist_field[..., None], dists[..., :3]], dim=-1)
    k = dist_field.clamp(0, 3)[..., None].long()
    j = torch.arange(4, device=dists.device)
    below = torch.cat([dists[..., :1], dists[..., :3]], dim=-1)  # d[j-1]
    promoted = torch.where(
        j == 0, torch.gather(dists, -1, k),
        torch.where(j <= k, below, dists))
    ptype = ptype[..., None]
    return torch.where(ptype == P.MATCH, pushed,
                       torch.where(ptype == P.LREP, promoted, dists))
