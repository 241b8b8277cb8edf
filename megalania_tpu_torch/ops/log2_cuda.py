"""Kernel 1: the exact-log2 correction.

The proposal kernel costs a bit as trunc(-log2(p/2048)*2048) in
float32 (csrc/meg_cost.cuh f32_log2_cost) plus a 2-bit correction that
makes the sum equal tables.LOG2_TABLE exactly (the repair kernel reads
the exact table).  The correction is built from what the device's
float32 path really returns: the kernel (csrc/log2_probe.cu) runs the
kernels' own f32_log2_cost for every p, compares it with the exact table,
packs the 2-bit codes into 128 words and reduces the deviation's range,
all in one launch.  The host reads the range (8 bytes) to raise as the
reference does; the words stay on the card.

Replaces: megalania_tpu/ops/pallas_repair2.py::log2_correction (its
probe _log2_probe_kernel and the host-side check and pack).  Bound on the
card: bytes, 8,192 read and 520 written (the words and the status), ~2.6
ns at 3.35 TB/s; one launch costs the card's launch floor, far above
that.  The kernel also writes the raw costs, a verification output that
the engine does not use: tests/test_torch_cuda.py holds them against
the exact table.  Plain version:
`correction_plain`, the same check and pack in torch on any device; on
the CPU the probe's plain version is the exact table itself.

Unlike the reference (functools.cache), nothing is cached: every block
context launches the kernel once, so each path that builds a context
shows the kernel's launch.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from . import tables as T

CORR_WORDS = 128                            # 16 two-bit codes a word


def _check_range(lo: int, hi: int):
    """Raise, with the reference's message, unless every deviation of the
    float32 cost from the exact table lies in -1..+1."""
    if lo < -1 or hi > 1:
        raise RuntimeError(
            "device float32 log2 deviates by >1 from the exact table "
            f"(min {lo}, max {hi}); widen the correction")


def log2_probe_plain(device) -> torch.Tensor:
    """The exact costs the probe approximates: LOG2_TABLE[max(p, 1)]."""
    exact = T.LOG2_TABLE_I32.copy()
    exact[0] = exact[1]                     # the probe clamps p=0 to 1
    return torch.as_tensor(exact, device=device)


def correction_plain(raw: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """The plain version: int32[128] words from a probe's raw float32
    costs int32[2048] and the exact table int32[2048], on their device.
    exact = raw + corr, corr in {-1, 0, +1} stored as the 2-bit code
    corr+1 at bit (p & 15) * 2 of word p >> 4.  Raises if the float32
    log2 is off by more than 1 anywhere."""
    exact = torch.cat([exact[1:2], exact[1:]])     # the probe clamps p=0
    diff = exact.long() - raw.long()
    _check_range(int(diff.min()), int(diff.max()))
    shifts = 2 * torch.arange(16, device=diff.device)
    words = ((diff + 1).view(CORR_WORDS, 16) << shifts).sum(1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def log2_correction_cuda(exact: torch.Tensor):
    """The kernel on the exact table int32[2048] (a CUDA tensor): (corr
    int32[128], raw int32[2048], status int32[2] = min and max of
    exact - raw), slices of one buffer on the card.  Reads status, the
    only host sync, and raises as correction_plain does."""
    cuda_lib.require(exact, "exact", (T.PROB_ONE,))
    buf = torch.empty(T.PROB_ONE + CORR_WORDS + 2, dtype=torch.int32,
                      device=exact.device)
    with torch.cuda.device(exact.device):
        err = cuda_lib.lib().meg_log2_correction(
            cuda_lib.ptr(exact), cuda_lib.ptr(buf), cuda_lib.stream())
    cuda_lib.check(err, "log2_correction")
    log2_correction_cuda.launches += 1
    raw, corr, status = buf.split([T.PROB_ONE, CORR_WORDS, 2])
    _check_range(*status.tolist())
    return corr, raw, status


log2_correction_cuda.launches = 0


def log2_correction(exact: torch.Tensor) -> torch.Tensor:
    """The correction words for the exact table's device: the kernel on
    cuda, the plain version of probe and correction on cpu."""
    if exact.is_cuda:
        return log2_correction_cuda(exact)[0]
    return correction_plain(log2_probe_plain(exact.device), exact)


def build_correction(raw) -> np.ndarray:
    """The numpy oracle of correction_plain against tables.LOG2_TABLE
    (the reference's own loop): int32[128] words from raw costs."""
    approx = np.asarray(raw).reshape(-1).astype(np.int64)
    exact = T.LOG2_TABLE_NP.copy()
    exact[0] = exact[1]                     # probe clamps index 0 to 1
    diff = exact - approx
    _check_range(int(diff.min()), int(diff.max()))
    enc = (diff + 1).astype(np.uint64)      # 2-bit codes
    packed = np.zeros(CORR_WORDS, np.uint64)
    for j in range(16):
        packed |= enc[j::16] << np.uint64(2 * j)
    return packed.astype(np.int64).astype(np.int32)


def apply_correction(raw, corr) -> np.ndarray:
    """raw + decoded correction for every p (the kernels' exact cost)."""
    p = np.arange(T.PROB_ONE)
    c = np.asarray(corr, np.int64)
    code = (c[p >> 4] >> ((p & 15) * 2)) & 3
    return np.asarray(raw, np.int64) + code - 1
