// The block's Pareto candidate table, one thread per position.
//
// Replaces no TPU kernel: the JAX package, like the port until now, builds
// this table on the host (match/candidates.py::build_candidates, rounds of
// masked numpy over all positions, one LCE query per position a round).
// The table is built twice for every block context, the annealer's
// (max_candidates x max_walk, 20 x 96) and the optimum-parse seed's
// (opt_candidates x opt_walk, 64 x 1,024); at 64 KiB the seed's alone is
// ~26M LCE queries, seconds of host time.
//
// Thread p walks its bigram chain c = prev[p], prev[c], ... nearest first,
// at most `walk` steps, with the numpy loop's rule at each step:
//   ext = min(lce(p, c), 273);
//   take (dist p - c - 1, length ext) into the next slot when
//     ext >= 2 && ext > best && count < M;
//   best = max(best, ext);
//   stop after ext >= 273.
// It also stops at count == M, after which the loop takes nothing.  The
// output is CandidateTable's layout and slot order, bit for bit.
//
// Bound on the card: latency.  The bytes are the index read once (rank,
// prev, the sparse table: ~4.5 MiB at 64 KiB) and the table written once
// (2 x n x M int32), microseconds at 3.35 TB/s.  Each step is two dependent
// gathers (rank[c] and prev[c] side by side, then the two sparse-table
// minima), served from L2, where the whole index stays.  So the design is
// only to keep every walk in flight at once: one thread a position,
// best, count and the slot in registers, the index read through the
// read-only path.  Each block first zeroes its own rows of the table
// (coalesced), so empty slots need no second pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatchLenMin = 2, kMatchLenMax = 273;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
candidates_kernel(const int32_t* __restrict__ prev,
                  const int32_t* __restrict__ rank,
                  const int32_t* __restrict__ sparse, int n, int M, int walk,
                  int32_t* __restrict__ dist, int32_t* __restrict__ length,
                  int32_t* __restrict__ count) {
  const int row0 = blockIdx.x * kThreads;
  const int64_t lo_i = int64_t(row0) * M;
  const int64_t hi_i = int64_t(min(row0 + kThreads, n)) * M;
  for (int64_t i = lo_i + threadIdx.x; i < hi_i; i += kThreads) {
    dist[i] = 0;
    length[i] = 0;
  }
  __syncthreads();
  const int p = row0 + threadIdx.x;
  if (p >= n) return;
  int32_t* d_row = dist + int64_t(p) * M;
  int32_t* l_row = length + int64_t(p) * M;
  const int rp = __ldg(rank + p);
  int c = __ldg(prev + p), cnt = 0, best = 0;
  for (int step = 0; step < walk && c >= 0 && cnt < M; ++step) {
    const int rc = __ldg(rank + c);
    const int next = __ldg(prev + c);
    // suffix.lce_np: ranks differ (c < p), so the span is at least 1
    const int lo = min(rp, rc) + 1, hi = max(rp, rc) + 1;
    const int k = 31 - __clz(hi - lo);
    const int32_t* row = sparse + int64_t(k) * n;
    const int ext = min(min(__ldg(row + lo), __ldg(row + hi - (1 << k))),
                        kMatchLenMax);
    if (ext >= kMatchLenMin && ext > best) {
      d_row[cnt] = p - c - 1;
      l_row[cnt] = ext;
      ++cnt;
    }
    best = max(best, ext);
    if (ext >= kMatchLenMax) break;
    c = next;
  }
  count[p] = cnt;
}

}  // namespace

extern "C" int meg_candidates(const int32_t* prev, const int32_t* rank,
                              const int32_t* sparse, int n, int M, int walk,
                              int32_t* dist, int32_t* length, int32_t* count,
                              cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  candidates_kernel<<<blocks, kThreads, 0, stream>>>(
      prev, rank, sparse, n, M, walk, dist, length, count);
  return int(cudaGetLastError());
}
