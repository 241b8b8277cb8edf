// Kernel 1: the float32 log2 probe.
//
// Replaces megalania_tpu/ops/pallas_repair2.py::_log2_probe_kernel.  Each
// of 2048 threads evaluates the shared f32_log2_cost(max(p, 1)) for one p;
// the host (ops/log2_cuda.py) turns the result into the 2-bit correction
// that makes the kernels' float32 log2 exact against tables.LOG2_TABLE.
// Bound: nothing (one launch of 2048 threads per block context); it
// exists so that the correction is measured on this device with the very
// function the repair and rank kernels call.

#include "meg_cost.cuh"

namespace {

__global__ void log2_probe_kernel(int32_t* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < meg::kProbOne) out[p] = meg::f32_log2_cost(max(p, 1));
}

}  // namespace

extern "C" int meg_log2_probe(int32_t* out, cudaStream_t stream) {
  log2_probe_kernel<<<meg::kProbOne / 256, 256, 0, stream>>>(out);
  return int(cudaGetLastError());
}
