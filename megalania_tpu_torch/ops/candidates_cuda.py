"""The block's Pareto candidate table on the card.

The kernel (csrc/candidates.cu, one thread per position walking its
bigram chain) behind match/candidates.candidate_table on cuda; on cpu
that function runs the numpy build_candidates itself, unchanged, as the
plain version.  The kernel's table is bit-identical to the numpy one at
every n, M and walk; on a CUDA tensor it launches or raises.

Replaces no TPU kernel: the JAX package builds the table on the host.
Bound on the card: latency, a chain of dependent gathers into an index
that stays in L2 (see the kernel's source).  `bigram_prev` (one argsort)
stays on the host and is uploaded as int32.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def candidates_cuda(prev, rank, sparse, max_candidates: int,
                    max_walk: int):
    """The kernel: prev, rank int32[n] and sparse int32[K, n] on one
    CUDA device -> (dist, length int32[n, M], count int32[n]), tensors
    there: a match/candidates.CandidateTable's fields."""
    n, M = prev.shape[0], max_candidates
    cuda_lib.require(prev, "prev", (n,))
    cuda_lib.require(rank, "rank", (n,))
    kw = dict(dtype=torch.int32, device=prev.device)
    if n < 2:                       # no bigram: build_candidates' early out
        return (torch.zeros((n, M), **kw), torch.zeros((n, M), **kw),
                torch.zeros(n, **kw))
    cuda_lib.require(sparse, "sparse", (None, n))
    if sparse.shape[0] < (n - 1).bit_length():
        raise ValueError(f"sparse: {sparse.shape[0]} rows are too few "
                         f"for LCE queries over {n} positions")
    dist, length = (torch.empty((n, M), **kw) for _ in range(2))
    count = torch.empty(n, **kw)
    p = cuda_lib.ptr
    with torch.cuda.device(prev.device):
        err = cuda_lib.lib().meg_candidates(
            p(prev), p(rank), p(sparse), n, M, max_walk, p(dist), p(length),
            p(count), cuda_lib.stream())
    cuda_lib.check(err, "candidates")
    candidates_cuda.launches += 1
    return dist, length, count


candidates_cuda.launches = 0

