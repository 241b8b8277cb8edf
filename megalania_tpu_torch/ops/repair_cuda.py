"""Kernel 2: the fused mutate + repair + exact re-cost pass.

`repair_cost` is the engine's one dispatch point: tensors on cuda go to
the CUDA kernel (csrc/repair.cu), tensors on cpu to the plain version
(ops/repair_scan.py, flat probabilities, converted at this boundary).
On a CUDA tensor the kernel launches or this raises; nothing falls back.

Replaces: megalania_tpu/ops/pallas_repair2.py::_kernel (wrapper
repair_cost_pallas2).  Bound on the card: the per-chain walk is
sequential and latency-bound (each repaired length decides the next
packet start; every adaptive bit is a dependent shared-memory update).
The design keeps the chain's probabilities in shared memory, one warp
per chain, lanes on the slots of a packet, and walks straight from one
live position to the next (see csrc/repair.cu).

Outputs, in order: (slab [C,n], cost_hi [C], cost_lo [C], snap probs
[C, PACKED_ROWS] class-packed, rec_ctx [C], rec_dists [C,4], rec_live
[C], live_count [C], snap_carry [C,16]).
"""
from __future__ import annotations

import torch

from . import cuda_lib, repair_scan
from . import problayout as PL
from . import tables as T


def repair_cost_plain(slabs, q, u, data, cand_dist, cand_len, log2, *,
                      site_mode="byte", lrep_fallback="litsrep", lc=0,
                      mut0=None, mut1=None, start_pos=None, cap_pos=None,
                      probs_in=None, carry_in=None):
    """The plain version (any device), class-packed at the boundary."""
    lay = PL.get_layout(lc)
    out = repair_scan.repair_cost_batched(
        slabs, q, u, data, cand_dist, cand_len, log2, site_mode=site_mode,
        lrep_fallback=lrep_fallback, start_pos=start_pos, cap_pos=cap_pos,
        probs_in=None if probs_in is None else lay.flat_from_packed(probs_in),
        carry_in=carry_in, lc=lc, mut0=mut0, mut1=mut1)
    return out[:3] + (lay.packed_from_flat(out[3]),) + out[4:]


def repair_cost_cuda(slabs, q, u, data, cand_dist, cand_len, corr, *,
                     site_mode="byte", lrep_fallback="litsrep", lc=0,
                     mut0=None, mut1=None, start_pos=None, cap_pos=None,
                     probs_in=None, carry_in=None):
    """The CUDA kernel.  start_pos/cap_pos may be ints or 0-d device
    tensors (read by the kernel, so the host never waits for them)."""
    C, n = slabs.shape
    M = cand_dist.shape[1]
    PR = PL.get_layout(lc).PACKED_ROWS
    dev = slabs.device
    i32 = torch.int32
    if probs_in is None:
        probs_in = torch.full((C, PR), T.PROB_INIT, dtype=i32, device=dev)
    if carry_in is None:
        carry_in = torch.zeros((C, 16), dtype=i32, device=dev)
    if mut0 is None:
        mpos = torch.full((C,), -2, dtype=i32, device=dev)  # no substitution
        mut0 = mut1 = torch.zeros((C,), dtype=i32, device=dev)
    else:
        mpos = torch.clamp(q, 0, n - 1).to(i32)
    sc = torch.stack([
        torch.as_tensor(0 if start_pos is None else start_pos, dtype=i32,
                        device=dev).reshape(()),
        torch.as_tensor(n if cap_pos is None else cap_pos, dtype=i32,
                        device=dev).reshape(())])
    for name, t, shape in (
            ("slabs", slabs, (C, n)), ("q", q, (C,)), ("u", u, (C,)),
            ("mut0", mut0, (C,)), ("mut1", mut1, (C,)), ("data", data, (n,)),
            ("cand_dist", cand_dist, (n, M)), ("cand_len", cand_len, (n, M)),
            ("corr", corr, (128,)), ("probs_in", probs_in, (C, PR)),
            ("carry_in", carry_in, (C, 16))):
        cuda_lib.require(t, name, shape)
    out_slab = torch.empty((C, n), dtype=i32, device=dev)
    snap_probs = torch.empty((C, PR), dtype=i32, device=dev)
    snap_carry = torch.empty((C, 16), dtype=i32, device=dev)
    misc = torch.empty((C, 9), dtype=i32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        err = cuda_lib.lib().meg_repair(
            p(slabs), p(q), p(u), p(mpos), p(mut0), p(mut1), p(data),
            p(cand_dist), p(cand_len), p(corr), p(probs_in), p(carry_in),
            p(sc), p(out_slab), p(snap_probs), p(snap_carry), p(misc),
            C, n, M, PR, lc, int(site_mode == "packet"),
            int(lrep_fallback == "match"),
            cuda_lib.layout_array(lc).ctypes.data, cuda_lib.stream())
    cuda_lib.check(err, "repair")
    repair_cost_cuda.launches += 1
    return (out_slab, misc[:, 0], misc[:, 1], snap_probs, misc[:, 2],
            misc[:, 3:7], misc[:, 7], misc[:, 8], snap_carry)


repair_cost_cuda.launches = 0


def repair_cost(slabs, q, u, data, cand_dist, cand_len, log2, corr, **kw):
    """Dispatch on the slabs' device: CUDA kernel or plain version."""
    if slabs.is_cuda:
        return repair_cost_cuda(slabs, q, u, data, cand_dist, cand_len,
                                corr, **kw)
    return repair_cost_plain(slabs, q, u, data, cand_dist, cand_len, log2,
                             **kw)
