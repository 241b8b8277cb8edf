"""Exact whole-parse costing, one step per byte position
(megalania_tpu/ops/scan_cost.py, a lax.scan there).

A step is active only at a live packet start, where it compiles the
packet's bit plan, costs it and adapts the probabilities.  Every step is
batched over a leading chain axis.  Not on the annealer's main path (the
repair kernel costs the chains there); tools and tests use it as the
exact cost of a parse.  On cuda it runs the same torch ops as on cpu.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import bitplan
from . import tables as T
from ..models import lzma_state as S
from ..models import packets as P
from ..utils import fixedpoint as fp


class CostCarry(NamedTuple):
    probs: torch.Tensor     # int32[B, PROBS_PAD]
    ctx: torch.Tensor       # int32[B]
    dists: torch.Tensor     # int32[B, 4]
    live_pos: torch.Tensor  # int32[B]
    cost_hi: torch.Tensor   # int32[B]
    cost_lo: torch.Tensor   # int32[B]


def init_carry(batch: int = 1, lc: int = 0, device="cpu") -> CostCarry:
    """The fresh coder state for `batch` parses."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    probs = torch.as_tensor(T.init_probs_np((batch,), lc=lc), device=device)
    return CostCarry(probs=probs.to(torch.int32).contiguous(),
                     ctx=zeros(batch), dists=zeros(batch, 4),
                     live_pos=zeros(batch), cost_hi=zeros(batch),
                     cost_lo=zeros(batch))


def packet_step(carry: CostCarry, i: int, entry, data, log2, lc: int = 0):
    """Process slab position i (entry: int32[B] packed words there;
    carry.probs is adapted in place).  Returns (carry', live[B])."""
    active = carry.live_pos == i
    ptype, dist, length, _ = P.unpack(entry)
    n = data.shape[0]
    byte = data[i].expand_as(entry)
    match_byte = data[torch.clamp(i - carry.dists[:, 0] - 1, 0, n - 1)]
    prev_byte = data[i - 1] if i > 0 else torch.zeros_like(data[0])
    plan = bitplan.make_bit_plan(ptype, dist, length, carry.ctx,
                                 carry.dists, byte, match_byte,
                                 prev_byte=prev_byte.expand_as(entry), lc=lc)
    plan = plan._replace(active=plan.active & active[:, None],
                         n_direct=torch.where(active, plan.n_direct, 0))
    cost = bitplan.apply_plan(carry.probs, plan, log2, lc=lc)
    hi, lo = fp.accumulate(carry.cost_hi, carry.cost_lo, cost)
    return CostCarry(
        probs=carry.probs,
        ctx=torch.where(active, S.ctx_next(carry.ctx, ptype), carry.ctx),
        dists=torch.where(active[:, None],
                          S.dists_next(carry.dists, ptype, dist),
                          carry.dists),
        live_pos=carry.live_pos + torch.where(active, length, 0),
        cost_hi=hi, cost_lo=lo), active


def parse_cost(slab, data, log2, lc: int = 0):
    """Exact cost of parses.

    slab: int32[n] or int32[C, n] packed words (models/packets.py); data:
    int32[n] bytes; log2: the int32 cost table (tables.LOG2_TABLE_I32) on
    the same device.  Returns (cost_hi, cost_lo, final_probs, live): [C],
    [C], [C, PROBS_PAD], bool[C, n], without the chain axis for a 1-d
    slab."""
    single = slab.dim() == 1
    slab2 = slab.reshape(-1, slab.shape[-1])
    carry = init_carry(slab2.shape[0], lc, slab.device)
    live = []
    with torch.inference_mode():
        for i in range(slab2.shape[1]):
            carry, act = packet_step(carry, i, slab2[:, i], data, log2, lc)
            live.append(act)
    live = (torch.stack(live, dim=1) if live
            else torch.zeros(slab2.shape, dtype=torch.bool,
                             device=slab.device))
    out = (carry.cost_hi, carry.cost_lo, carry.probs, live)
    return tuple(t[0] for t in out) if single else out


def parse_cost_exact(slab, data, lc: int = 0):
    """parse_cost with the exact log2 table supplied on the slab's device
    (the counterpart of the reference's parse_cost_jit)."""
    log2 = torch.as_tensor(T.LOG2_TABLE_I32, device=slab.device)
    return parse_cost(slab, data, log2, lc=lc)
