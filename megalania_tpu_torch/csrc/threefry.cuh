// The jax.random subset the annealer draws from, as device functions:
// the bit-exact counterparts of megalania_tpu_torch/utils/threefry.py
// (jax.random's threefry2x32 with jax_threefry_partitionable=True).
//
//   split(key, num)[i]       = threefry2x32(key, (0, i))
//   random_bits(key, shape)  element i = the two words of
//                              threefry2x32(key, (0, i)) xor-ed
//   randint(key, (), 0, span) from random_bits of split(key, 2)[0] and [1]
//   uniform(key)             = float(bits >> 9 | 0x3F800000) - 1
//
// Keys are two uint32 words; the port stores them as int64 pairs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf {

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on the counter (x1, x2).
__device__ __forceinline__ Key threefry2x32(Key k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, kRot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  return {x1, x2};
}

// split(key, num)[i]; num only sizes the counter, so it is not needed
__device__ __forceinline__ Key split(Key k, uint32_t i) {
  return threefry2x32(k, 0u, i);
}

// element i of random_bits(key, shape)
__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t i) {
  const Key h = threefry2x32(k, 0u, i);
  return h.a ^ h.b;
}

// jax.random.randint(..., minval=0, maxval=span) from the element's two
// 32-bit draws (random_bits of split(key, 2)[0] and [1]); span <= 0
// draws from [0, 1) as jax does when maxval <= minval.  uint32
// arithmetic wraps as in jax.
__device__ __forceinline__ int32_t randint(uint32_t higher, uint32_t lower,
                                           int32_t span) {
  const uint32_t s = span <= 0 ? 1u : uint32_t(span);
  uint32_t mult = (1u << 16) % s;
  mult = mult * mult % s;
  const uint32_t off = (higher % s) * mult + lower % s;
  return int32_t(off % s);
}

// jax.random.uniform (float32 in [0, 1)) from 32 random bits
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace tf
