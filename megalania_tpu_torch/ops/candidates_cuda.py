"""The block's Pareto candidate table on the card.

`candidate_table` builds match/candidates.build_candidates' table on the
device of the block's LCE index (rank and sparse as tensors): on cuda
the kernel (csrc/candidates.cu, one thread per position walking its
bigram chain), on cpu the numpy builder itself, unchanged, as the plain
version.  The kernel's table is bit-identical to the numpy one at every
n, M and walk; on a CUDA tensor it launches or raises.

Replaces no TPU kernel: the JAX package builds the table on the host.
Bound on the card: latency, a chain of dependent gathers into an index
that stays in L2 (see the kernel's source).  `bigram_prev` (one argsort)
stays on the host and is uploaded as int32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from ..match import candidates as C_
from ..match.suffix import LCEIndex


def candidates_cuda(prev, rank, sparse, max_candidates: int,
                    max_walk: int) -> C_.CandidateTable:
    """The kernel: prev, rank int32[n] and sparse int32[K, n] on one
    CUDA device -> CandidateTable(dist, length int32[n, M], count
    int32[n]) of tensors there."""
    n, M = prev.shape[0], max_candidates
    cuda_lib.require(prev, "prev", (n,))
    cuda_lib.require(rank, "rank", (n,))
    kw = dict(dtype=torch.int32, device=prev.device)
    if n < 2:                       # no bigram: build_candidates' early out
        return C_.CandidateTable(torch.zeros((n, M), **kw),
                                 torch.zeros((n, M), **kw),
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
    return C_.CandidateTable(dist, length, count)


candidates_cuda.launches = 0


def candidate_table(data, max_candidates: int, max_walk: int,
                    rank: torch.Tensor,
                    sparse: torch.Tensor) -> C_.CandidateTable:
    """The table of uint8 `data` as tensors on the device of rank and
    sparse (suffix.build_lce's arrays of `data` there): the kernel on
    cuda, the numpy build_candidates on cpu."""
    if not rank.is_cuda:
        return C_.CandidateTable(*(torch.from_numpy(a) for a in
                                   C_.build_candidates(
                                       data, max_candidates, max_walk,
                                       host_index(rank, sparse))))
    prev = torch.as_tensor(C_.bigram_prev(data).astype(np.int32),
                           device=rank.device)
    return candidates_cuda(prev, rank, sparse, max_candidates, max_walk)


def host_index(rank: torch.Tensor, sparse: torch.Tensor) -> LCEIndex:
    """The LCE index of the tensors rank and sparse as numpy arrays on
    the host: views of cpu tensors, a download of cuda ones."""
    return LCEIndex(rank=rank.cpu().numpy(), sparse=sparse.cpu().numpy(),
                    n=rank.shape[0])


def to_numpy(tab: C_.CandidateTable) -> C_.CandidateTable:
    """The table as numpy arrays on the host (the greedy init and the
    native DP read it there)."""
    return C_.CandidateTable(*(t.cpu().numpy() for t in tab))
