// Kernel 1: the exact-log2 correction, probe and encoding in one launch.
//
// Replaces megalania_tpu/ops/pallas_repair2.py::log2_correction: its Pallas
// probe _log2_probe_kernel and the range check and 2-bit pack that run
// around it on the host.  The card computes what that function returns.
//
// One block of 1024 threads; thread t takes p = t and p = t + 1024.  For
// each p it evaluates f32_log2_cost(max(p, 1)) (meg_cost.cuh: the very
// non-inlined function the proposal kernel calls, so the correction is
// exact for that kernel by construction), the deviation
// d = exact[max(p, 1)] - raw, and the 2-bit code d + 1 at bit (p & 15) * 2.
// An OR over each 16 lanes (shuffles) gives word p >> 4, and the range of d
// is reduced over the block (warp reductions, then shared memory).
//
// Output: one int32 buffer, raw[2048] | corr[128] | status[2] = (min d,
// max d).  The host reads status (8 bytes) to raise, as the reference
// does, when |d| > 1; corr stays on the card.  raw is a verification
// output: the engine uses only corr, and raw lets the tests and the smoke
// test hold the float32 path against the exact table.
//
// Bound: bytes, 8,192 read and 520 written, the words and the status
// (~2.6 ns at 3.35 TB/s; raw's 8,192 B come on top of that).  One launch
// of one block costs the card's launch floor, far above that; what the
// design removes is the host round trip of the probe's 8 KiB.

#include <climits>

#include "meg_cost.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "warp 0 reduces one entry per warp per lane");

__global__ void __launch_bounds__(kThreads)
log2_correction_kernel(const int32_t* __restrict__ exact,
                       int32_t* __restrict__ out) {
  __shared__ int lo_w[kWarps], hi_w[kWarps];
  int32_t* raw = out;
  int32_t* corr = out + meg::kProbOne;
  int32_t* status = corr + meg::kCorrWords;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo = INT_MAX, hi = INT_MIN;
  // every lane of a warp runs both rounds, so the shuffles see full warps
  for (int p = threadIdx.x; p < meg::kProbOne; p += kThreads) {
    const int pc = max(p, 1);                     // p = 0 costs as p = 1
    const int r = meg::f32_log2_cost(pc);
    const int d = exact[pc] - r;
    raw[p] = r;
    uint32_t code = (uint32_t(d + 1) & 3u) << ((p & 15) * 2);
    for (int o = 1; o < 16; o <<= 1)
      code |= __shfl_xor_sync(meg::kFullMask, code, o);
    if ((p & 15) == 0) corr[p >> 4] = int32_t(code);
    lo = min(lo, d);
    hi = max(hi, d);
  }
  lo = __reduce_min_sync(meg::kFullMask, lo);
  hi = __reduce_max_sync(meg::kFullMask, hi);
  if (lane == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = __reduce_min_sync(meg::kFullMask, lo_w[lane]);
    hi = __reduce_max_sync(meg::kFullMask, hi_w[lane]);
    if (lane == 0) {
      status[0] = lo;
      status[1] = hi;
    }
  }
}

}  // namespace

extern "C" int meg_log2_correction(const int32_t* exact, int32_t* out,
                                   cudaStream_t stream) {
  log2_correction_kernel<<<1, kThreads, 0, stream>>>(exact, out);
  return int(cudaGetLastError());
}
