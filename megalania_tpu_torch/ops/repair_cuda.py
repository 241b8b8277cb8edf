"""Kernel 2: the fused mutate + repair + exact re-cost pass.

`repair_cost` is the engine's one dispatch point: tensors on cuda go to
the CUDA kernel (csrc/repair.cu), tensors on cpu to the plain version
(ops/repair_scan.py, flat probabilities, converted at this boundary).
On a CUDA tensor the kernel launches or this raises; nothing falls back.

Replaces: megalania_tpu/ops/pallas_repair2.py::_kernel (wrapper
repair_cost_pallas2).  Bound on the card: the per-chain walk is
sequential, so the dependent chain of one packet bounds it, not memory.
The kernel splits a chain's work over five warps of one block (a walker
that makes the repair decisions, two planners that compute the packets'
bit plans, a coster that codes the bits and adapts the probabilities, a
stager that moves the slab by bulk copy), with the block's bytes in
shared memory where `staging_plan` finds room (see csrc/repair.cu).

Outputs, in order: (slab [C,n], cost_hi [C], cost_lo [C], snap probs
[C, PACKED_ROWS] class-packed, rec_ctx [C], rec_dists [C,4], rec_live
[C], live_count [C], snap_carry [C,16]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib, repair_scan
from . import problayout as PL
from . import tables as T

# Shared memory a block may use on the H100 (227 KB with the opt-in).
SMEM_LIMIT = 232_448
# Mirrors of csrc/repair.cu's constants; the kernel's host entry checks
# that its own plan has the size computed here.
_TILE_WORDS = 1024 + 4        # a slab tile and its quad offset, int32
_RING = 128                   # packet records (16 B) and their plans (128 B)
_BARRIERS = 7 + 2 * (_RING // 8) + _RING // 32
_LOG2_WORDS = 2048
_LAYOUT_INTS = 26 + 5 * 11    # meg::kLayoutInts


class StagingPlan(NamedTuple):
    bytes_in_smem: bool       # the block's bytes staged in shared memory
    smem_bytes: int           # the kernel's dynamic shared memory


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def staging_plan(n: int, lc: int) -> StagingPlan:
    """Where the repair kernel reads the block's n bytes from: shared
    memory when they fit beside the barriers, the record and plan rings,
    two slab tiles, the log2 table, the layout and the lc's
    probabilities;
    otherwise the uint8 copy in device memory.  One kernel, a template
    branch chosen here by size."""
    fixed = (_r16(8 * _BARRIERS) + (16 + 128) * _RING
             + 4 * 2 * _TILE_WORDS
             + 4 * _LOG2_WORDS + _r16(4 * _LAYOUT_INTS)
             + _r16(4 * PL.get_layout(lc).PACKED_ROWS))
    if fixed + _r16(n) <= SMEM_LIMIT:
        return StagingPlan(True, fixed + _r16(n))
    return StagingPlan(False, fixed)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a fresh copy if a view leaves it off a 16-byte boundary
    (the kernel moves these rows by bulk copy)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def repair_cost_cuda(slabs, q, u, data_u8, cand_dist, cand_len, log2, *,
                     site_mode="byte", lrep_fallback="litsrep", lc=0,
                     mut0=None, mut1=None, start_pos=None, cap_pos=None,
                     probs_in=None, carry_in=None):
    """The CUDA kernel: the block's bytes as uint8[n], the exact log2
    table as int32[2048].  start_pos/cap_pos may be ints or 0-d device
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
    for name, t, shape, dtype in (
            ("slabs", slabs, (C, n), i32), ("q", q, (C,), i32),
            ("u", u, (C,), i32), ("mut0", mut0, (C,), i32),
            ("mut1", mut1, (C,), i32), ("data_u8", data_u8, (n,), torch.uint8),
            ("cand_dist", cand_dist, (n, M), i32),
            ("cand_len", cand_len, (n, M), i32),
            ("log2", log2, (T.PROB_ONE,), i32),
            ("probs_in", probs_in, (C, PR), i32),
            ("carry_in", carry_in, (C, 16), i32)):
        cuda_lib.require(t, name, shape, dtype)
    slabs, data_u8, log2, probs_in = (
        _aligned(slabs), _aligned(data_u8), _aligned(log2),
        _aligned(probs_in))
    plan = staging_plan(n, lc)
    out_slab = torch.empty((C, n), dtype=i32, device=dev)
    snap_probs = torch.empty((C, PR), dtype=i32, device=dev)
    snap_carry = torch.empty((C, 16), dtype=i32, device=dev)
    misc = torch.empty((C, 9), dtype=i32, device=dev)
    p = cuda_lib.ptr
    with torch.cuda.device(dev):
        err = cuda_lib.lib().meg_repair(
            p(slabs), p(q), p(u), p(mpos), p(mut0), p(mut1), p(data_u8),
            p(cand_dist), p(cand_len), p(log2), p(probs_in), p(carry_in),
            p(sc), p(out_slab), p(snap_probs), p(snap_carry), p(misc),
            C, n, M, PR, lc, int(site_mode == "packet"),
            int(lrep_fallback == "match"), int(plan.bytes_in_smem),
            plan.smem_bytes, cuda_lib.layout_array(lc).ctypes.data,
            cuda_lib.stream())
    cuda_lib.check(err, "repair")
    repair_cost_cuda.launches += 1
    repair_cost_cuda.staged["shared" if plan.bytes_in_smem else "device"] += 1
    return (out_slab, misc[:, 0], misc[:, 1], snap_probs, misc[:, 2],
            misc[:, 3:7], misc[:, 7], misc[:, 8], snap_carry)


repair_cost_cuda.launches = 0
# launches by where the kernel read the block's bytes (staging_plan)
repair_cost_cuda.staged = {"shared": 0, "device": 0}


def repair_cost(slabs, q, u, data, data_u8, cand_dist, cand_len, log2,
                **kw):
    """Dispatch on the slabs' device: the CUDA kernel (which reads the
    uint8 bytes) or the plain version (the int32 ones)."""
    if slabs.is_cuda:
        return repair_cost_cuda(slabs, q, u, data_u8, cand_dist, cand_len,
                                log2, **kw)
    return repair_cost_plain(slabs, q, u, data, cand_dist, cand_len, log2,
                             **kw)
