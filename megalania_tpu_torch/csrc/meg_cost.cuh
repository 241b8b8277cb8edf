// Device code shared by the three kernels (log2_probe.cu, repair.cu,
// rank.cu): packet unpack/pack, the 26-slot bit plan (with the 8 literal
// bits and the matched-literal rule), the ctx and rep-stack transitions,
// the float32 log2 cost and its 2-bit exactness correction.
//
// Probabilities are addressed in the class-packed layout of
// megalania_tpu_torch/ops/problayout.py: a slot's row is the first row of
// its class plus a within-class index.  The class offsets arrive from the
// host in a `Layout` (problayout is the single source of truth).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace meg {

constexpr int kProbOne = 2048;
constexpr int kProbBits = 11;
constexpr int kMoveBits = 5;
constexpr int kLit = 0, kMatch = 1, kSrep = 2, kLrep = 3;
constexpr int kNSlots = 26;
constexpr int kCorrWords = 128;
constexpr uint32_t kLiveBit = 1u << 31;
constexpr unsigned kFullMask = 0xffffffffu;

// problayout class order
enum {
  kIsMatch, kIsRep, kG0, kG1R0L, kG2, kLch,
  kLtree0, kDst0 = kLtree0 + 8, kRt0 = kDst0 + 6, kLitCls = kRt0 + 5,
  kNumCls
};

struct Layout {
  int row[kNumCls];    // first packed row of each class
  int rt_off[5][11];   // offset of reverse tree `tid` within class rt<t>
};
constexpr int kLayoutInts = kNumCls + 5 * 11;

struct Packet {
  int type, dist, len;
};

__device__ __forceinline__ Packet unpack(uint32_t w) {
  return {int((w >> 29) & 3u), int(w & 0xFFFFFu), int((w >> 20) & 0x1FFu)};
}

__device__ __forceinline__ uint32_t pack_live(const Packet& p) {
  return (uint32_t(p.dist) & 0xFFFFFu) | ((uint32_t(p.len) & 0x1FFu) << 20) |
         ((uint32_t(p.type) & 3u) << 29) | kLiveBit;
}

// trunc(-log2(pc / 2048) * 2048) in float32 for pc in 1..2047.  Never
// inlined: the probe and the kernels run one and the same instruction
// sequence, so the probe's correction is exact for the kernels by
// construction.  (Built without --use_fast_math.)
static __device__ __noinline__ int f32_log2_cost(int pc) {
  const float x = float(pc) * (1.0f / 2048.0f);
  return int(truncf(-log2f(x) * 2048.0f));
}

// correction in {-1, 0, +1}: 2-bit code (value + 1) at bit (pc & 15) * 2
// of word pc >> 4
__device__ __forceinline__ int log2_corr(const int* corr, int pc) {
  return ((corr[pc >> 4] >> ((pc & 15) * 2)) & 3) - 1;
}

// the clipped prob index whose cost codes `bit` against prob p
__device__ __forceinline__ int cost_index(int p, int bit) {
  const int pc = bit ? kProbOne - p : p;
  return min(max(pc, 1), kProbOne - 1);
}

__device__ __forceinline__ int adapt(int p, int bit) {
  return bit ? p - (p >> kMoveBits) : p + ((kProbOne - p) >> kMoveBits);
}

__device__ __forceinline__ int ctx_next(int ctx, int type) {
  switch (type) {
    case kLit: return ctx < 4 ? 0 : (ctx < 10 ? ctx - 3 : ctx - 6);
    case kMatch: return ctx < 7 ? 7 : 10;
    case kSrep: return ctx < 7 ? 9 : 11;
    default: return ctx < 7 ? 8 : 11;
  }
}

// rep-stack update: MATCH pushes, LREP promotes entry `dist`, LIT/SREP
// keep the stack
__device__ __forceinline__ void dists_next(int d[4], int type, int dist) {
  if (type == kMatch) {
    d[3] = d[2]; d[2] = d[1]; d[1] = d[0]; d[0] = dist;
  } else if (type == kLrep) {
    const int k = min(max(dist, 0), 3);
    const int dk = d[k];
    for (int j = k; j > 0; --j) d[j] = d[j - 1];
    d[0] = dk;
  }
}

// Everything the slots of one packet read.
struct PlanCtx {
  int type, dist, len, ctx;
  int byte, mb;      // data byte at the position, byte one rep0 back
  int lit_row0;      // first row of the literal sub-table (lc context)
  int len2, ps, nlb_t;
};

__device__ __forceinline__ PlanCtx plan_ctx(const Packet& p, int ctx,
                                            int byte, int mb, int prev,
                                            int lc, const Layout& L) {
  PlanCtx c;
  c.type = p.type;
  c.dist = p.dist;
  c.len = p.len;
  c.ctx = ctx;
  c.byte = byte;
  c.mb = mb;
  c.lit_row0 = L.row[kLitCls] + (lc ? (prev >> (8 - lc)) * 0x300 : 0);
  c.len2 = max(p.len - 2, 0);
  const int bl = 32 - __clz(p.dist);            // bit length; clz(0) = 32
  c.nlb_t = max(bl - 2, 0);
  c.ps = p.dist < 4 ? p.dist : c.nlb_t * 2 + (p.dist >> c.nlb_t);
  return c;
}

__device__ __forceinline__ int n_direct(const PlanCtx& c) {
  return (c.type == kMatch && c.ps >= 14) ? c.nlb_t - 4 : 0;
}

// Slot j (0..25) of the packet's bit plan: whether it is coded, and if so
// its packed prob row and bit.  Order and semantics of ops/bitplan.py:
// 0..4 header, 5..14 length coder (literal bits in 5..12), 15..20
// distance slot tree, 21..25 reverse tree.
__device__ __forceinline__ bool plan_slot(const PlanCtx& c, int j,
                                          const Layout& L, int* row,
                                          int* bit) {
  const bool is_lit = c.type == kLit, is_match = c.type == kMatch;
  const bool is_lrep = c.type == kLrep, is_rep = c.type >= kSrep;
  if (j < 5) {
    const bool b3 = is_lrep && c.dist != 0;
    const int b4 = b3 ? int(c.dist != 1) : int(is_lrep);
    switch (j) {
      case 0: *row = L.row[kIsMatch] + c.ctx; *bit = !is_lit; return true;
      case 1: *row = L.row[kIsRep] + c.ctx; *bit = is_rep; return !is_lit;
      case 2: *row = L.row[kG0] + c.ctx; *bit = b3; return is_rep;
      case 3:
        *row = L.row[kG1R0L] + (b3 ? c.ctx : 12 + c.ctx);
        *bit = b4;
        return is_rep;
      default:
        *row = L.row[kG2] + c.ctx;
        *bit = c.dist != 2;
        return is_rep && b3 && b4 == 1;
    }
  }
  if (j < 15) {
    if (is_lit) {                                 // literal bit k
      const int k = j - 5;
      if (k >= 8) return false;
      const int sym = (1 << k) | (c.byte >> (8 - k));
      const int mbit = (c.mb >> (7 - k)) & 1;
      // matched mode holds while the match byte agrees on bits above k
      const bool prefix_eq = ((c.byte ^ c.mb) >> (8 - k)) == 0;
      const int sel = (c.ctx >= 7 && prefix_eq) ? 1 + mbit : 0;
      *row = c.lit_row0 + sym + (sel << 8);
      *bit = (c.byte >> (7 - k)) & 1;
      return true;
    }
    if (!(is_match || is_lrep)) return false;
    const int repc = is_lrep, c1 = c.len2 >= 8, c2 = c.len2 >= 16;
    if (j == 5) { *row = L.row[kLch] + repc; *bit = c1; return true; }
    if (j == 6) { *row = L.row[kLch] + 2 + repc; *bit = c2; return c1; }
    const int k = j - 7;                          // length tree level
    const int nbits = c2 ? 8 : 3;
    if (k >= nbits) return false;
    const int tval = !c1 ? c.len2 : (!c2 ? c.len2 - 8 : c.len2 - 16);
    const int tsel = k < 3 ? (c2 ? 4 + repc : repc * 2 + c1) : repc;
    *row = L.row[kLtree0 + k] + (tsel << k) + (tval >> (nbits - k));
    *bit = (tval >> (nbits - 1 - k)) & 1;
    return true;
  }
  if (!is_match) return false;
  if (j < 21) {                                   // distance slot tree
    const int k = j - 15;
    const int len_ctx = min(c.len2, 3);
    *row = L.row[kDst0 + k] + (len_ctx << k) + (c.ps >> (6 - k));
    *bit = (c.ps >> (5 - k)) & 1;
    return true;
  }
  if (c.ps < 4) return false;                     // reverse tree level t
  const int t = j - 21;
  const bool mid = c.ps < 14;
  const int nlb = mid ? (c.ps >> 1) - 1 : 4;
  if (t >= nlb) return false;
  const int low = c.dist & ((1 << nlb) - 1);
  const int tid = mid ? c.ps - 4 : 10;
  int rev = 0;
  for (int s = 0; s < t; ++s) rev = (rev << 1) | ((low >> s) & 1);
  *row = L.row[kRt0 + t] + L.rt_off[t][tid] + rev;
  *bit = (low >> t) & 1;
  return true;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace meg
