"""Per-packet bit-op compilation: the packet encoder as tensor math.

Within a single packet every adaptive bit touches a *distinct*
probability slot (bit-tree node indices strictly grow; header/len/dist
groups are disjoint arrays), so a packet compiles to a fixed-width vector
of NSLOTS (slot, bit, active) triples plus a direct-bits count.

Slot layout (order == emission order):
    0..4    packet-header flag bits
    5..14   length coder (MATCH/LREP)  -- or literal bits in 5..12 (LIT)
    15..20  distance pos-slot tree      (MATCH)
    [direct bits: logically between slot 20 and 21]
    21..25  pos_coder / align reverse tree (MATCH)

Every function here is batched over arbitrary leading axes (packets,
chains, candidates) where the reference vmaps one packet at a time; the
slot axis is last.  Semantics follow megalania_tpu/ops/bitplan.py value
for value, inactive slots included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import tables as T
from ..models import packets as P

NSLOTS = 26
_DIRECT_AFTER_SLOT = 20  # direct bits are emitted after this slot index


class BitPlan(NamedTuple):
    idx: torch.Tensor        # int32[..., NSLOTS] flat prob-table slots
    bit: torch.Tensor        # int32[..., NSLOTS] bit values 0/1
    active: torch.Tensor     # bool[..., NSLOTS]
    n_direct: torch.Tensor   # int32[...] number of direct (prob-free) bits
    direct_val: torch.Tensor  # int32[...] their value (for emission)


def bit_length(d):
    """Exact bit length of non-negative int tensors below 2**31 (torch
    has no clz): the count of powers of two <= d."""
    pow2 = torch.tensor([1 << j for j in range(31)], dtype=d.dtype,
                        device=d.device)
    return (d[..., None] >= pow2).sum(-1).to(torch.int32)


def _tree_msb(value, nbits, base, nslots):
    """Bit-tree, MSB first: after j steps the node is
    (1<<j) | (value >> (nbits-j))."""
    j = torch.arange(nslots, dtype=torch.int32, device=value.device)
    v, nb = value[..., None], nbits[..., None]
    active = j < nb
    m = (1 << j) | (v >> torch.clamp(nb - j, min=0))
    bit = (v >> torch.clamp(nb - 1 - j, min=0)) & 1
    return base[..., None] + m, bit, active


def _tree_rev(value, nbits, base, nslots):
    """Bit-tree, LSB first: node m = (1<<j) | bit-reverse(low j bits)."""
    j = torch.arange(nslots, dtype=torch.int32, device=value.device)
    v, nb = value[..., None], nbits[..., None]
    rev = torch.zeros_like(v)
    revs = []
    for t in range(nslots):              # rev_j = reverse(low j bits)
        revs.append(rev)
        rev = (rev << 1) | ((v >> t) & 1)
    m = (1 << j) | torch.cat(revs, dim=-1)
    bit = (v >> j) & 1
    active = j < nb
    return base[..., None] + m, bit, active


def make_bit_plan(ptype, dist, length, ctx, dists, byte, match_byte,
                  prev_byte=None, lc: int = 0) -> BitPlan:
    """Compile packets into their bit plans.

    ptype/dist/length: packet fields [...] (LREP's `dist` is the rep-stack
    index).  ctx/dists: coder state *before* the packet ([...], [..., 4];
    dists is unused by the plan itself and kept for signature parity).
    byte/match_byte: the data byte at the position / the byte one
    rep0-distance back (used only when ctx >= 7).  lc selects the
    literal-context model: the top lc bits of prev_byte pick one of 2^lc
    literal sub-tables.
    """
    i32 = torch.int32
    ptype, dist, length, ctx, byte, match_byte = (
        torch.as_tensor(x).to(i32)
        for x in (ptype, dist, length, ctx, byte, match_byte))
    shape = torch.broadcast_shapes(ptype.shape, dist.shape, length.shape,
                                   ctx.shape, byte.shape, match_byte.shape)
    ptype, dist, length, ctx, byte, match_byte = (
        x.expand(shape) for x in (ptype, dist, length, ctx, byte,
                                  match_byte))
    dev = ptype.device

    is_lit = ptype == P.LIT
    is_match = ptype == P.MATCH
    is_srep = ptype == P.SREP
    is_lrep = ptype == P.LREP
    is_rep = is_srep | is_lrep

    # ---- header flag bits (slots 0..4) --------------------------------
    b3 = is_lrep & (dist != 0)
    b4 = torch.where(b3, (dist != 1).to(i32), is_lrep.to(i32))
    b5 = (dist != 2).to(i32)
    h_idx = torch.stack([
        T.IS_MATCH + (ctx << T.POS_BITS_MAX),
        T.IS_REP + ctx,
        T.IS_REP_G0 + ctx,
        torch.where(b3, T.IS_REP_G1 + ctx,
                    T.IS_REP0_LONG + (ctx << T.POS_BITS_MAX)),
        T.IS_REP_G2 + ctx,
    ], dim=-1)
    h_bit = torch.stack([(~is_lit).to(i32), is_rep.to(i32), b3.to(i32), b4,
                         b5], dim=-1)
    h_act = torch.stack([torch.ones_like(is_lit), ~is_lit, is_rep, is_rep,
                         is_rep & b3 & (b4 == 1)], dim=-1)

    # ---- length coder (slots 5..14, MATCH/LREP) -----------------------
    len_active = is_match | is_lrep
    len2 = torch.clamp(length - T.MATCH_LEN_MIN, min=0)
    base = torch.where(is_match, T.LEN, T.REP_LEN).to(i32)
    c1 = len2 >= 8
    c2 = len2 >= 16
    tree_base = base + torch.where(
        ~c1, T.LEN_LOW, torch.where(~c2, T.LEN_MID, T.LEN_HIGH)).to(i32)
    tree_nb = torch.where(c2, 8, 3).to(i32)
    tree_val = torch.where(~c1, len2, torch.where(~c2, len2 - 8, len2 - 16))
    lt_idx, lt_bit, lt_act = _tree_msb(tree_val, tree_nb, tree_base, 8)
    len_idx = torch.cat([torch.stack([base + T.LEN_CHOICE1,
                                      base + T.LEN_CHOICE2], dim=-1),
                         lt_idx], dim=-1)
    len_bit = torch.cat([torch.stack([c1.to(i32), c2.to(i32)], dim=-1),
                         lt_bit], dim=-1)
    len_act = torch.cat([torch.stack([len_active, len_active & c1], dim=-1),
                         lt_act & len_active[..., None]], dim=-1)

    # ---- literal bits (overlay slots 5..12, LIT only) -----------------
    j8 = torch.arange(8, dtype=i32, device=dev)
    lbits = (byte[..., None] >> (7 - j8)) & 1
    mbits = (match_byte[..., None] >> (7 - j8)) & 1
    # matched-byte context stays on while the match byte agrees bit-by-bit
    eq = (lbits == mbits).to(i32)
    prefix_eq = torch.cat([torch.ones_like(eq[..., :1]),
                           torch.cumprod(eq, dim=-1)[..., :7].to(i32)],
                          dim=-1)
    matched = (ctx >= 7).to(i32)[..., None] * prefix_eq
    symbol = (1 << j8) | (byte[..., None] >> (8 - j8))
    lit_idx = T.LIT + symbol + matched * ((1 + mbits) << 8)
    if lc:
        prev = torch.as_tensor(prev_byte).to(i32).to(dev)
        lit_idx = lit_idx + ((prev >> (8 - lc)) * 0x300)[..., None]
    zeros2 = torch.zeros(shape + (2,), dtype=i32, device=dev)
    lit_idx10 = torch.cat([lit_idx, zeros2], dim=-1)
    lit_bit10 = torch.cat([lbits, zeros2], dim=-1)
    lit_act = torch.cat([is_lit[..., None].expand(shape + (8,)),
                         zeros2.bool()], dim=-1)

    lit_sel = is_lit[..., None]
    mid_idx = torch.where(lit_sel, lit_idx10, len_idx)
    mid_bit = torch.where(lit_sel, lit_bit10, len_bit)
    mid_act = torch.where(lit_sel, lit_act, len_act)

    # ---- distance coder (slots 15..25, MATCH only) --------------------
    d = dist
    nlb_t = torch.clamp(bit_length(d) - 2, min=0)
    high = d >> nlb_t
    ps = torch.where(d < 4, d, nlb_t * 2 + high)  # pos slot
    len_ctx = torch.clamp(len2, max=3)
    ds_idx, ds_bit, ds_act = _tree_msb(
        ps, torch.full_like(ps, 6), T.DIST_SLOT + 64 * len_ctx, 6)
    ds_act = ds_act & is_match[..., None]

    midrange = (ps >= 4) & (ps < 14)
    nlb = torch.where(midrange, (ps >> 1) - 1, 4).to(i32)
    low = d & ((1 << nlb) - 1)
    rbase = torch.where(midrange, T.POS_CODER + (high << nlb) - ps,
                        T.ALIGN).to(i32)
    rt_idx, rt_bit, rt_act = _tree_rev(low, nlb, rbase, 5)
    rt_act = rt_act & (is_match & (ps >= 4))[..., None]

    n_direct = torch.where(is_match & (ps >= 14), nlb_t - 4, 0).to(i32)
    direct_val = torch.where(
        n_direct > 0,
        (d >> 4) & ((1 << torch.clamp(n_direct, min=0)) - 1), 0).to(i32)

    idx = torch.cat([h_idx, mid_idx, ds_idx, rt_idx], dim=-1).to(i32)
    bit = torch.cat([h_bit, mid_bit, ds_bit, rt_bit], dim=-1).to(i32)
    active = torch.cat([h_act, mid_act, ds_act, rt_act], dim=-1)
    return BitPlan(idx, bit, active, n_direct, direct_val)


def _log2_cost(log2, p, bit):
    # inactive slots may read the dead slot's 0: keep their index in range
    pc = torch.where(bit == 1, T.PROB_ONE - p, p)
    return log2[pc.clamp(0, T.PROB_ONE - 1).long()]


def plan_cost(probs, plan: BitPlan, log2, lc: int = 0):
    """Exact fixed-point cost (bits << 11) of plans under flat `probs`
    ([..., PROBS_PAD], leading axes matching the plan's).  Read-only:
    all slots within a packet are distinct."""
    safe = torch.where(plan.active, plan.idx, T.dead_slot(lc)).long()
    p = torch.gather(probs, -1, safe)
    c = _log2_cost(log2, p, plan.bit)
    return (torch.where(plan.active, c, 0).sum(-1)
            + (plan.n_direct << T.PROB_BITS)).to(torch.int32)


def plan_cost_packed(packed, plan: BitPlan, log2, f2p, lc: int = 0):
    """plan_cost against the class-packed probability layout.

    `packed`: [..., PACKED_ROWS] (ops/problayout.py), leading axes
    matching the plan's (broadcast over any extra plan axes);
    `f2p`: flat-slot -> packed-row map (problayout.F2P_PAD).  Slots that
    map to -1 read PROB_INIT; they are always inactive."""
    safe = torch.where(plan.active, plan.idx, T.dead_slot(lc)).long()
    row = f2p[safe]
    flat_rows = torch.clamp(row, min=0).long()
    lead = flat_rows.shape[:-1]
    src = packed.reshape(packed.shape[:1] + (1,) * (len(lead) - 1)
                         + packed.shape[1:]).expand(lead + packed.shape[-1:])
    p = torch.where(row >= 0, torch.gather(src, -1, flat_rows), T.PROB_INIT)
    c = _log2_cost(log2, p, plan.bit)
    return (torch.where(plan.active, c, 0).sum(-1)
            + (plan.n_direct << T.PROB_BITS)).to(torch.int32)


def apply_plan(probs, plan: BitPlan, log2, lc: int = 0):
    """Cost the plans and adapt `probs` ([B, PROBS_PAD]) IN PLACE (the
    port's plain repair pass owns its probability buffer).  -> cost [B]."""
    safe = torch.where(plan.active, plan.idx, T.dead_slot(lc)).long()
    p = torch.gather(probs, -1, safe)
    c = _log2_cost(log2, p, plan.bit)
    cost = (torch.where(plan.active, c, 0).sum(-1)
            + (plan.n_direct << T.PROB_BITS)).to(torch.int32)
    adapted = torch.where(plan.bit == 1, p - (p >> T.MOVE_BITS),
                          p + ((T.PROB_ONE - p) >> T.MOVE_BITS))
    probs.scatter_(-1, safe, torch.where(plan.active, adapted, p))
    return cost
