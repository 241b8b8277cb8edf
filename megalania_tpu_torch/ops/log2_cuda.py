"""Kernel 1: the float32 log2 probe, and the exact-log2 correction.

The repair and rank kernels cost a bit as trunc(-log2(p/2048)*2048) in
float32 (csrc/meg_cost.cuh f32_log2_cost) plus a 2-bit correction that
makes the sum equal tables.LOG2_TABLE exactly.  The correction is built
from what the device's float32 path really returns: the probe kernel
runs the kernels' own f32_log2_cost for every p, and the host encodes
the difference to the exact table.

Replaces: megalania_tpu/ops/pallas_repair2.py::_log2_probe_kernel (via
log2_correction).  Bound on the card: none worth naming — one launch of
2048 threads per block context.  Plain version: the exact table itself.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from . import tables as T


def log2_probe_plain(device) -> torch.Tensor:
    """The exact costs the probe approximates: LOG2_TABLE[max(p, 1)]."""
    exact = T.LOG2_TABLE_I32.copy()
    exact[0] = exact[1]                     # the probe clamps p=0 to 1
    return torch.as_tensor(exact, device=device)


def log2_probe_cuda(device) -> torch.Tensor:
    """int32[2048]: the device's f32_log2_cost(max(p, 1)) for each p."""
    out = torch.empty(T.PROB_ONE, dtype=torch.int32, device=device)
    with torch.cuda.device(out.device):
        err = cuda_lib.lib().meg_log2_probe(cuda_lib.ptr(out),
                                            cuda_lib.stream())
    cuda_lib.check(err, "log2_probe")
    log2_probe_cuda.launches += 1
    return out


log2_probe_cuda.launches = 0


def log2_probe(device) -> torch.Tensor:
    """The probe on `device`: the kernel on cuda, the plain version on cpu."""
    if torch.device(device).type == "cuda":
        return log2_probe_cuda(device)
    return log2_probe_plain(device)


def build_correction(raw) -> np.ndarray:
    """int32[128] packed correction from a probe's raw float32 costs:
    exact = raw + corr, corr in {-1, 0, +1} stored as the 2-bit code
    corr+1 at bit (p & 15) * 2 of word p >> 4.  Raises if the device's
    float32 log2 is off by more than 1 anywhere."""
    approx = np.asarray(raw).reshape(-1).astype(np.int64)
    exact = T.LOG2_TABLE_NP.copy()
    exact[0] = exact[1]                     # probe clamps index 0 to 1
    diff = exact - approx
    if diff.min() < -1 or diff.max() > 1:
        raise RuntimeError(
            "device float32 log2 deviates by >1 from the exact table "
            f"(min {diff.min()}, max {diff.max()}); widen the correction")
    enc = (diff + 1).astype(np.uint64)      # 2-bit codes
    packed = np.zeros(128, np.uint64)
    for j in range(16):
        packed |= enc[j::16] << np.uint64(2 * j)
    return packed.astype(np.int64).astype(np.int32)


def log2_correction(device) -> torch.Tensor:
    """The correction words for `device`, built from its own probe."""
    raw = log2_probe(device).cpu().numpy()
    return torch.as_tensor(build_correction(raw), device=device)


def apply_correction(raw, corr) -> np.ndarray:
    """raw + decoded correction for every p (the kernels' exact cost)."""
    p = np.arange(T.PROB_ONE)
    c = np.asarray(corr, np.int64)
    code = (c[p >> 4] >> ((p & 15) * 2)) & 3
    return np.asarray(raw, np.int64) + code - 1
