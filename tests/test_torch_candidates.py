"""The block's Pareto candidate table (ops/candidates_cuda.py) on the
CPU: the port's numpy builder equals the reference's
(megalania_tpu.match.candidates) on every case, a scalar walk written
like the kernel's loop (csrc/candidates.cu, one thread per position)
equals the numpy builder, row for row, and candidates.candidate_table
leaves the CPU on the numpy builder.  The kernel itself is held to the numpy table on
the card (test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from candidate_cases import CASES, block, index, numpy_table
from megalania_tpu.match import candidates as ref_candidates
from megalania_tpu.match import suffix as ref_suffix
from megalania_tpu_torch.match import candidates as C_
from megalania_tpu_torch.ops import candidates_cuda
from megalania_tpu_torch.ops import tables as T

SAMPLED = 512          # rows walked in Python on a 64 KiB block


def kernel_walk(prev, rank, sparse, p: int, M: int, walk: int):
    """Thread p of the kernel: its (dist, length) entries, nearest
    first."""
    dist, length = [], []
    c, best = prev[p], 0
    for _ in range(walk):
        if c < 0 or len(dist) == M:
            break
        lo = min(rank[p], rank[c]) + 1
        hi = max(rank[p], rank[c]) + 1
        k = (hi - lo).bit_length() - 1          # 31 - __clz(span)
        ext = min(sparse[k][lo], sparse[k][hi - (1 << k)], T.MATCH_LEN_MAX)
        if ext >= T.MATCH_LEN_MIN and ext > best:
            dist.append(p - c - 1)
            length.append(ext)
        best = max(best, ext)
        if ext >= T.MATCH_LEN_MAX:
            break
        c = prev[c]
    return dist, length


def rows(n: int):
    """Every row of a small block; on a large one every (n // SAMPLED)-th
    and the last 300, whose extensions run into the block's end."""
    if n <= 4096:
        return range(n)
    return sorted(set(range(0, n, n // SAMPLED)) | set(range(n - 300, n)))


@pytest.mark.parametrize("case", list(CASES))
def test_numpy_table_equals_reference(case):
    """The table every other test holds the kernel to is the reference
    package's, built from the reference's own LCE index."""
    name, M, walk = CASES[case]
    data = block(name)
    want = ref_candidates.build_candidates(data, M, walk,
                                           ref_suffix.build_lce(data))
    for f, got in zip(C_.CandidateTable._fields, numpy_table(case)):
        np.testing.assert_array_equal(got, getattr(want, f), err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_walk_equals_numpy_table(case):
    name, M, walk = CASES[case]
    data, idx = block(name), index(name)
    want = numpy_table(case)
    n = len(data)
    assert want.dist.shape == want.length.shape == (n, M)
    prev = C_.bigram_prev(data).tolist()
    rank, sparse = idx.rank.tolist(), idx.sparse.tolist()
    for p in rows(n):
        dist, length = kernel_walk(prev, rank, sparse, p, M, walk)
        cnt = len(dist)
        assert want.count[p] == cnt, p
        assert want.dist[p].tolist() == dist + [0] * (M - cnt), p
        assert want.length[p].tolist() == length + [0] * (M - cnt), p
    if name.startswith("stairs"):           # the count == M stop is hit
        assert want.count.max() == M
    if name == "byte64k":                   # every walk ends at the cap
        assert (want.length[1:n - 273, 0] == T.MATCH_LEN_MAX).all()


@pytest.mark.parametrize("case", ["survey2k-20x96", "stairs64-64x1024",
                                  "n1"])
def test_cpu_dispatch_is_the_numpy_table(case):
    """On CPU tensors candidate_table returns the numpy builder's arrays
    unchanged and launches nothing."""
    name, M, walk = CASES[case]
    idx = index(name)
    before = candidates_cuda.candidates_cuda.launches
    got = C_.candidate_table(block(name), M, walk, C_.BlockIndex(
        idx, torch.as_tensor(idx.rank), torch.as_tensor(idx.sparse)))
    assert candidates_cuda.candidates_cuda.launches == before
    for g, w in zip(got, numpy_table(case)):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(C_.to_numpy(got), numpy_table(case)):
        np.testing.assert_array_equal(g, w)


def test_kernel_refuses_cpu_tensors():
    idx = index("survey2k")
    prev = torch.as_tensor(C_.bigram_prev(block("survey2k")).astype(
        np.int32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        candidates_cuda.candidates_cuda(prev, torch.as_tensor(idx.rank),
                                        torch.as_tensor(idx.sparse), 20, 96)
