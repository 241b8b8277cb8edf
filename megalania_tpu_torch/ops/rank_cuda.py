"""Kernel 3: candidate ranking — exact cost of every proposal.

For each chain and each packed candidate (live bit = valid): the exact
bit cost under the chain's snapshot probabilities (class-packed) and its
recorded (ctx, rep stack); metric = cost // max(len, 1); BIG where
invalid.  `rank` dispatches on the device: the CUDA kernel
(csrc/rank.cu) on cuda, `rank_plain` on cpu, and raises rather than fall
back.

Replaces: megalania_tpu/ops/pallas_rank.py::_kernel (wrapper
rank_pallas); the literal candidate, which the TPU wrapper costed
outside its kernel, is costed in the kernel.  Bound on the card: small
— ~62 candidates x 26 slots per chain; the launch and the load of the
chain's probabilities into shared memory dominate.  One block per chain,
one thread per candidate.
"""
from __future__ import annotations

import torch

from . import bitplan, cuda_lib
from . import problayout as PL
from . import tables as T
from ..models import packets as P

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


def rank_cuda(probs, candp, rec_ctx, rec_dists, byte, match_byte,
              prev_byte, corr, lc: int = 0):
    """The CUDA kernel; same arguments as rank_plain plus the log2
    correction words."""
    C, NC = candp.shape
    PR = PL.get_layout(lc).PACKED_ROWS
    st = torch.cat([rec_ctx[:, None], rec_dists, byte[:, None],
                    match_byte[:, None], prev_byte[:, None]],
                   dim=1).to(torch.int32).contiguous()
    for name, t, shape in (("probs", probs, (C, PR)), ("candp", candp, None),
                           ("st", st, (C, 8)), ("corr", corr, (128,))):
        cuda_lib.require(t, name, shape)
    metric = torch.empty((C, NC), dtype=torch.int32, device=probs.device)
    p = cuda_lib.ptr
    with torch.cuda.device(probs.device):
        err = cuda_lib.lib().meg_rank(
            p(probs), p(candp), p(st), p(corr), p(metric), C, NC, PR, lc,
            cuda_lib.layout_array(lc).ctypes.data, cuda_lib.stream())
    cuda_lib.check(err, "rank")
    rank_cuda.launches += 1
    return metric


rank_cuda.launches = 0


def rank(probs, candp, rec_ctx, rec_dists, byte, match_byte, prev_byte,
         corr, lc: int = 0):
    """Dispatch on the probabilities' device."""
    if probs.is_cuda:
        return rank_cuda(probs, candp, rec_ctx, rec_dists, byte,
                         match_byte, prev_byte, corr, lc=lc)
    return rank_plain(probs, candp, rec_ctx, rec_dists, byte, match_byte,
                      prev_byte, lc=lc)
