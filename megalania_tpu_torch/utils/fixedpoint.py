"""64-bit fixed-point cost carried as an (hi, lo) int32 pair.

Costs are bits<<11; a 1 MiB block can exceed 2**31, so totals are held as
hi*2**16 + lo with 0 <= lo < 2**16 after normalization — the same pair
the reference carries, so states compare field by field.
"""
from __future__ import annotations

import numpy as np
import torch

LO_BITS = 16
LO_MASK = (1 << LO_BITS) - 1
INF_HI = np.int32(2**31 - 1)


def accumulate(hi, lo, delta):
    """Add a per-packet delta (< 2**30) and renormalize."""
    lo = lo + delta
    hi = hi + (lo >> LO_BITS)
    lo = lo & LO_MASK
    return hi, lo


def less(hi_a, lo_a, hi_b, lo_b):
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a < lo_b))


def to_int(hi, lo) -> int:
    """Host-side exact integer value."""
    return int(hi) * (1 << LO_BITS) + int(lo)


def argmin(hi, lo):
    """Exact lexicographic argmin over parallel (hi, lo) tensors (first
    index on ties): min hi, then argmin of lo among the rows at it."""
    masked_lo = torch.where(hi == hi.min(), lo, int(INF_HI))
    return torch.argmin(masked_lo)
