// Kernel 3: candidate ranking — the exact bit cost of every proposal.
//
// Replaces megalania_tpu/ops/pallas_rank.py::_kernel (wrapper
// rank_pallas).  Same result as the plain version,
// megalania_tpu_torch/ops/rank_cuda.py::rank_plain: for each chain and
// each packed candidate, cost = the packet's exact cost under the chain's
// snapshot probs and recorded (ctx, rep stack), metric = cost // max(len,
// 1), BIG where the candidate is invalid.  The literal candidate is
// costed here too (the TPU kernel left it to XLA).
//
// What bounds it on Hopper: ~62 candidates x 26 slots per chain of
// shared-memory gathers plus float32 log2 — a few thousand operations per
// chain, so the launch and the probability load dominate.  The design:
// one block per chain, the chain's probs read-only in shared memory, one
// thread per candidate summing its slots.

#include "meg_cost.cuh"

namespace {

constexpr int kBig = 1 << 30;

__global__ void rank_kernel(
    const int32_t* __restrict__ probs,   // [C, PR] class-packed
    const int32_t* __restrict__ candp,   // [C, NC] packed, live bit = valid
    const int32_t* __restrict__ st,      // [C, 8] ctx d0-3 byte mb prev
    const int32_t* __restrict__ corr,    // [128]
    int32_t* __restrict__ metric,        // [C, NC]
    int NC, int PR, int lc, meg::Layout L) {
  extern __shared__ int smem[];
  int* pr = smem;                        // [PR]
  int* corr_s = pr + PR;                 // [128]
  const int c = blockIdx.x;
  for (int k = threadIdx.x; k < PR; k += blockDim.x)
    pr[k] = probs[size_t(c) * PR + k];
  for (int k = threadIdx.x; k < meg::kCorrWords; k += blockDim.x)
    corr_s[k] = corr[k];
  __syncthreads();

  const int32_t* s = st + size_t(c) * 8;
  const int ctx = s[0], byte = s[5], mb = s[6], prev = s[7];
  for (int k = threadIdx.x; k < NC; k += blockDim.x) {
    const uint32_t w = uint32_t(candp[size_t(c) * NC + k]);
    const meg::Packet p = meg::unpack(w);
    const bool valid = (w & meg::kLiveBit) != 0;
    const meg::PlanCtx pc = meg::plan_ctx(p, ctx, byte, mb, prev, lc, L);
    int cost = meg::n_direct(pc) << meg::kProbBits;
    for (int j = 0; j < meg::kNSlots; ++j) {
      int row = 0, bit = 0;
      const bool act = valid && meg::plan_slot(pc, j, L, &row, &bit);
      const int ix = meg::cost_index(act ? pr[row] : meg::kProbOne / 2, bit);
      const int cj = meg::f32_log2_cost(ix) + meg::log2_corr(corr_s, ix);
      cost += act ? cj : 0;
    }
    metric[size_t(c) * NC + k] = valid ? cost / max(p.len, 1) : kBig;
  }
}

}  // namespace

extern "C" int meg_rank(const int32_t* probs, const int32_t* candp,
                        const int32_t* st, const int32_t* corr,
                        int32_t* metric, int C, int NC, int PR, int lc,
                        const int32_t* layout, cudaStream_t stream) {
  meg::Layout L;
  for (int k = 0; k < meg::kNumCls; ++k) L.row[k] = layout[k];
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 11; ++k) L.rt_off[t][k] = layout[meg::kNumCls + t * 11 + k];
  const size_t smem = sizeof(int) * (size_t(PR) + meg::kCorrWords);
  cudaError_t err = meg::allow_smem(rank_kernel, smem);
  if (err != cudaSuccess) return int(err);
  rank_kernel<<<C, 64, smem, stream>>>(probs, candp, st, corr, metric, NC,
                                       PR, lc, L);
  return int(cudaGetLastError());
}
