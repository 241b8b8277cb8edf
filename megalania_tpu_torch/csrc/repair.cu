// Kernel 2: fused mutate + repair + exact re-cost, one annealing move per
// chain.
//
// Replaces megalania_tpu/ops/pallas_repair2.py::_kernel (wrapper
// repair_cost_pallas2).  Same contract as the plain version,
// megalania_tpu_torch/ops/repair_scan.py, integer for integer.
//
// What bounds it on Hopper: the walk is sequential per chain — each
// packet's repair decides its length, which decides where the next
// packet starts — and every adaptive bit is a dependent shared-memory
// read-modify-write.  It is latency-bound, not bandwidth- or
// FLOP-bound.  The design:
//   * one thread block (one warp) per chain; the chain's probabilities
//     sit in shared memory as int32 in the class-packed layout (7.2 KB at
//     lc=0, 28.7 KB at lc=3, 53 KB at lc=4 with the dynamic opt-in);
//   * the scalar coder state lives in registers, replicated on every lane;
//   * the walk jumps from one live position straight to the next; dead
//     cells never enter the loop: the warp streams the slab through a
//     shared-memory tile, writing every cell with its live bit cleared
//     (and the mutation substituted) before the walk overwrites the live
//     ones;
//   * within a packet, lane j takes bit-plan slot j (every slot of a
//     packet touches a distinct probability), and a warp reduction sums
//     the exact cost; the long-rep candidate row is scanned across lanes.

#include "meg_cost.cuh"

namespace {

using meg::kFullMask;
constexpr int kTile = 1024;        // slab positions staged per tile

struct Carry {
  int ctx, d[4], live, hi, lo, since, rctx, rd[4], rlive, pord;
};

__global__ void __launch_bounds__(32) repair_kernel(
    const int32_t* __restrict__ slabs,     // [C, n] packed words
    const int32_t* __restrict__ qv,        // [C] repair start (unclipped)
    const int32_t* __restrict__ uv,        // [C] recording site
    const int32_t* __restrict__ mposv,     // [C] mutation site, -2 = none
    const int32_t* __restrict__ mut0,      // [C] word substituted at mpos
    const int32_t* __restrict__ mut1,      // [C] word at mpos + 1
    const int32_t* __restrict__ data,      // [n]
    const int32_t* __restrict__ cand_d,    // [n, M]
    const int32_t* __restrict__ cand_l,    // [n, M]
    const int32_t* __restrict__ corr,      // [128] log2 correction words
    const int32_t* __restrict__ probs_in,  // [C, PR] snapshot probs
    const int32_t* __restrict__ carry_in,  // [C, 16] snapshot carry
    const int32_t* __restrict__ sc,        // [2] start_pos, cap_pos
    int32_t* __restrict__ out_slab,        // [C, n]
    int32_t* __restrict__ snap_probs,      // [C, PR]
    int32_t* __restrict__ snap_carry,      // [C, 16]
    int32_t* __restrict__ misc,            // [C, 9] hi lo rctx rd0-3 rlive pord
    int n, int M, int PR, int lc, int packet_sites, int fb_match,
    meg::Layout L) {
  extern __shared__ int smem[];
  int* probs = smem;                       // [PR]
  int* corr_s = probs + PR;                // [128]
  int* tile = corr_s + meg::kCorrWords;    // [kTile]

  const int c = blockIdx.x, lane = threadIdx.x;
  const int32_t* slab = slabs + size_t(c) * n;
  int32_t* out = out_slab + size_t(c) * n;
  const int start = sc[0], cap = sc[1];
  const int q = qv[c], u = uv[c], mpos = mposv[c];
  const int32_t m0 = mut0[c], m1 = mut1[c];

  for (int k = lane; k < PR; k += 32) probs[k] = probs_in[size_t(c) * PR + k];
  for (int k = lane; k < meg::kCorrWords; k += 32) corr_s[k] = corr[k];
  const int32_t* ci = carry_in + size_t(c) * 16;
  Carry s;
  s.ctx = ci[0];
  for (int k = 0; k < 4; ++k) s.d[k] = ci[1 + k];
  s.live = ci[5]; s.hi = ci[6]; s.lo = ci[7]; s.since = ci[8];
  s.rctx = ci[9];
  for (int k = 0; k < 4; ++k) s.rd[k] = ci[10 + k];
  s.rlive = ci[14]; s.pord = ci[15];

  // the unwalked prefix passes through verbatim
  for (int k = lane; k < min(start, n); k += 32) out[k] = slab[k];

  bool captured = false;
  bool rec_pending = !packet_sites && u >= start && u < n;

  auto record = [&]() {
    s.rctx = s.ctx;
    for (int k = 0; k < 4; ++k) s.rd[k] = s.d[k];
    s.rlive = s.live;
  };
  auto capture = [&]() {                 // state entering position cap
    __syncwarp();
    for (int k = lane; k < PR; k += 32) snap_probs[size_t(c) * PR + k] = probs[k];
    if (lane == 0) {
      int32_t* o = snap_carry + size_t(c) * 16;
      o[0] = s.ctx;
      for (int k = 0; k < 4; ++k) o[1 + k] = s.d[k];
      o[5] = s.live; o[6] = s.hi; o[7] = s.lo;
      o[8] = 0;                          // `since` is pass-relative
      o[9] = s.rctx;
      for (int k = 0; k < 4; ++k) o[10 + k] = s.rd[k];
      o[14] = s.rlive; o[15] = s.pord;
    }
    captured = true;
  };
  // before the packet at position L (L = INT_MAX: after the last one):
  // sites before the capture point record first, the capture sees them
  auto prologue = [&](int L) {
    if (rec_pending && u < cap && L >= u) { record(); rec_pending = false; }
    if (!captured && L >= cap) capture();
    if (rec_pending && L >= u) { record(); rec_pending = false; }
  };

  bool stuck = false;                    // a zero-length packet ends the walk
  for (int b = start; b < n; b += kTile) {
    const int e = min(b + kTile, n);
    __syncwarp();
    for (int k = b + lane; k < e; k += 32) {
      int32_t w = slab[k];
      if (k == mpos) w = m0;
      else if (k == mpos + 1) w = m1;
      tile[k - b] = w;
      out[k] = int32_t(uint32_t(w) & ~meg::kLiveBit);
    }
    __syncwarp();
    while (!stuck && s.live < e) {
      const int pos = s.live;
      if (pos < b) { stuck = true; break; }   // contract: live >= start
      prologue(pos);
      if (packet_sites && s.pord == u) record();

      meg::Packet p = meg::unpack(uint32_t(tile[pos - b]));
      const bool in_repair = pos >= q;
      const int byte = data[pos];
      const int mb = data[min(max(pos - s.d[0] - 1, 0), n - 1)];
      if (in_repair) {
        const bool srep_ok = pos > 0 && s.d[0] + 1 <= pos && mb == byte;
        const bool count_ok = s.since < 4;
        if (p.type == meg::kLit || p.type == meg::kSrep) {
          p.type = (srep_ok && count_ok) ? meg::kSrep
                   : (srep_ok ? p.type : meg::kLit);
          p.dist = 0;
          p.len = 1;
        } else if (p.type == meg::kLrep) {
          // re-aim against the live stack: valid = the stack distance is
          // in this position's candidate row with enough extension
          bool hit[4] = {false, false, false, false};
          int ml = -1;
          const int32_t* cdr = cand_d + size_t(pos) * M;
          const int32_t* clr = cand_l + size_t(pos) * M;
          for (int m = lane; m < M; m += 32) {
            const int cd = cdr[m], cl = clr[m];
            for (int k = 0; k < 4; ++k) hit[k] |= cd == s.d[k] && cl >= p.len;
            ml = max(ml, cl);
          }
          bool valid[4];
          for (int k = 0; k < 4; ++k)
            valid[k] = __any_sync(kFullMask, hit[k]) && s.d[k] + 1 <= pos;
          const int cur = min(max(p.dist, 0), 3);
          const bool cur_ok = valid[cur];
          const bool any = valid[0] || valid[1] || valid[2] || valid[3];
          const int first = valid[0] ? 0 : (valid[1] ? 1 : (valid[2] ? 2 : 3));
          int bd = 0, flen = 0;
          bool use_m = false;
          if (fb_match) {                // longest table match, nearest on ties
            ml = meg::warp_max(ml);
            int dmin = 1 << 30;
            for (int m = lane; m < M; m += 32)
              if (clr[m] == ml) dmin = min(dmin, int(cdr[m]));
            bd = meg::warp_min(dmin);
            flen = min(ml, n - pos);
            use_m = !(cur_ok || any) && flen >= 2;
          }
          if (cur_ok || any) {
            p.dist = cur_ok ? cur : first;
          } else if (use_m) {
            p.type = meg::kMatch; p.dist = bd; p.len = flen;
          } else {
            p.type = (srep_ok && count_ok) ? meg::kSrep : meg::kLit;
            p.dist = 0;
            p.len = 1;
          }
        }
      }

      // exact cost + adaptation: lane j codes slot j
      const int prev = pos > 0 ? data[pos - 1] : 0;
      const meg::PlanCtx pc = meg::plan_ctx(p, s.ctx, byte, mb, prev, lc, L);
      int row = 0, bit = 0;
      const bool act = lane < meg::kNSlots && meg::plan_slot(pc, lane, L, &row, &bit);
      const int pr = act ? probs[row] : meg::kProbOne / 2;
      const int ix = meg::cost_index(pr, bit);
      const int cbit = meg::f32_log2_cost(ix) + meg::log2_corr(corr_s, ix);
      if (act) probs[row] = meg::adapt(pr, bit);
      const int cost = meg::warp_sum(act ? cbit : 0) +
                       (meg::n_direct(pc) << meg::kProbBits);
      s.lo += cost;
      s.hi += s.lo >> 16;
      s.lo &= 0xFFFF;

      if (lane == 0) out[pos] = int32_t(meg::pack_live(p));
      s.ctx = meg::ctx_next(s.ctx, p.type);
      meg::dists_next(s.d, p.type, p.dist);
      s.live = pos + p.len;
      s.since += in_repair;
      s.pord += 1;
      stuck = p.len == 0;
      __syncwarp();
    }
  }
  prologue(0x7fffffff);
  if (!captured) capture();

  if (lane == 0) {
    int32_t* o = misc + size_t(c) * 9;
    o[0] = s.hi; o[1] = s.lo; o[2] = s.rctx;
    for (int k = 0; k < 4; ++k) o[3 + k] = s.rd[k];
    o[7] = s.rlive; o[8] = s.pord;
  }
}

}  // namespace

extern "C" int meg_repair(
    const int32_t* slabs, const int32_t* q, const int32_t* u,
    const int32_t* mpos, const int32_t* mut0, const int32_t* mut1,
    const int32_t* data, const int32_t* cand_d, const int32_t* cand_l,
    const int32_t* corr, const int32_t* probs_in, const int32_t* carry_in,
    const int32_t* sc, int32_t* out_slab, int32_t* snap_probs,
    int32_t* snap_carry, int32_t* misc, int C, int n, int M, int PR, int lc,
    int packet_sites, int fb_match, const int32_t* layout,
    cudaStream_t stream) {
  meg::Layout L;
  for (int k = 0; k < meg::kNumCls; ++k) L.row[k] = layout[k];
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 11; ++k) L.rt_off[t][k] = layout[meg::kNumCls + t * 11 + k];
  const size_t smem = sizeof(int) * (size_t(PR) + meg::kCorrWords + kTile);
  cudaError_t err = meg::allow_smem(repair_kernel, smem);
  if (err != cudaSuccess) return int(err);
  repair_kernel<<<C, 32, smem, stream>>>(
      slabs, q, u, mpos, mut0, mut1, data, cand_d, cand_l, corr, probs_in,
      carry_in, sc, out_slab, snap_probs, snap_carry, misc, n, M, PR, lc,
      packet_sites, fb_match, L);
  return int(cudaGetLastError());
}
