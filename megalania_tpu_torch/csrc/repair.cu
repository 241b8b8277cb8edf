// Kernel 2: fused mutate + repair + exact re-cost, one annealing move per
// chain.
//
// Replaces megalania_tpu/ops/pallas_repair2.py::_kernel (wrapper
// repair_cost_pallas2).  Same contract as the plain version,
// megalania_tpu_torch/ops/repair_scan.py, integer for integer.
//
// What bounds it on Hopper: the walk is sequential per chain.  Each
// packet's repair decides its length, which decides where the next packet
// starts, and every coded bit is a read-modify-write of an adaptive
// probability.  A full walk of a 64 KiB block moves ~70 MB (~21 us at
// 3.35 TB/s) but walks ~34,000 packets per chain one after another, so
// the bound is the issue latency of one packet's instructions, not
// memory.  The first design ran the whole packet as one warp per block:
// every stall of the packet (L2 loads of the block's bytes, a call to the
// float32 log2, a five-shuffle sum, a __syncwarp) added to the next
// packet's start, with nothing else on the SM to issue.
//
// The design now, one block of five warps per chain in a pipeline
// through shared memory (the walker, the coster and a planner each have a
// scheduler to themselves):
//   * walker (warp 1): the repair decisions.  They read only the rep
//     stack, `since`, the block's bytes and the candidate rows, never a
//     probability.  It advances `live`, writes each live word into the
//     staged tile and hands one 16-byte record per packet (pos, packet,
//     ctx, byte, match byte, previous byte, capture/end marks) on through
//     a ring, published 8 records per mbarrier and released 32 at a time.
//     The block's bytes sit in shared memory when they fit (staging_plan
//     in ops/repair_cuda.py picks the branch by size).  It looks one
//     packet ahead: each packet issues the next packet's word and byte
//     loads as soon as its own length and rep0 are known, so they arrive
//     while the record is built.  The common packet (a literal or short
//     rep) takes one branch: its re-type is selects, a match's push is
//     moves, and only a long rep branches into the re-aim, which loads its
//     candidate row and reduces it with one redux per quantity.  One
//     position test covers both kinds of recording event, and every lane
//     stores the record, so the lane is tested only when a chunk of
//     records is published.
//   * planners (warps 3 and 4, the records of even and odd index): each
//     record's bit plan.  Lane j computes slot j's row and bit (the order
//     and semantics of meg::plan_slot): the lane's class row is read once,
//     and per packet the lanes compute their rows by selects, with a short
//     path for literals.  One word per lane goes to a plan ring beside the
//     records, with the record's capture/end marks.
//   * coster (warp 2): lane j codes slot j of each plan and adapts its
//     probability.  Every probability row belongs to one slot, so to one
//     lane (tests/test_torch_repair.py checks this), and the lane's own
//     program order is all the ordering the updates need.  The bit cost is
//     the exact LOG2_TABLE in shared memory (equal to the float32 probe +
//     correction for p in 1..2047, which chip_smoke phase 3 checks).  Each
//     lane sums in 64 bits; one warp reduction at the capture and one at
//     the end normalise to (hi, lo) as the per-packet carry would.
//   * stager (warp 0): the slab through two 1024-position tiles, each
//     loaded with cp.async.bulk on an mbarrier while the walker is in the
//     other; it clears the live bits and substitutes the mutation in
//     shared memory, and after the walker has written the tile's live
//     words stores it with one bulk copy, so each cell reaches device
//     memory once.  It also copies the unwalked prefix, 16 bytes a lane.
// The capture runs in order: the walker writes its carry fields at the
// marked packet and the coster, reaching that record, writes the
// probabilities and (hi, lo) as they stand before it.
//
// What bounds it now: the coster.  tools/profile_torch_iter.py counts each
// role's cycles: at the main path's 64 KiB block the walker is busy ~342
// cycles a packet and waits for ring slots, the coster ~394 and barely
// waits, so a faster walk needs fewer coster instructions per packet.
// The walker's loop is issue-bound, one warp on its scheduler: each
// conditional branch costs it ~18 issue cycles, and a load left pending
// across a branch or into the next packet makes the compiler wait on it
// at once (the scoreboards are few).  Hence one branch on the common
// path, and the lookahead's loads settled at the packet's end.
// chip_smoke phase 2 prints ptxas's registers, stack and spills for each
// kernel (-Xptxas -v); the shared memory is staging_plan's (108,304 bytes
// for the main path's 64 KiB block at lc=0).
//
// Every wait has a watchdog: a wait that outlasts ~5 s of clock traps, so
// a fault shows as a failed launch, never as a hung card.

#include "meg_cost.cuh"

namespace {

using meg::kFullMask;
constexpr int kTile = 1024;                 // slab positions per tile
constexpr int kTileWords = kTile + 4;       // + the row's quad offset
constexpr int kRing = 128;                  // packet records in flight
constexpr int kFill = 8;                    // records published at once
constexpr int kChunk = 32;                  // records released at once
constexpr int kLog2Words = 2048;
constexpr int kPlanners = 2;      // planner warps, one per record parity
constexpr int kThreads = 32 * (3 + kPlanners);  // walker, coster, stager
constexpr uint32_t kCapFlag = 1, kEndFlag = 2;
constexpr long long kWatchdog = 1ll << 33;  // clock cycles

// mbarriers, at the start of shared memory
enum {
  kBarInit,                    // TMA: log2 table, probabilities, bytes
  kBarTma,                     // [2] TMA of a slab tile
  kBarReady = kBarTma + 2,     // [2] tile staged (32 stager arrivals)
  kBarDone = kBarReady + 2,    // [2] tile walked (walker lane 0)
  kBarFull = kBarDone + 2,     // [kRing / kFill] records written
  kBarPlan = kBarFull + kRing / kFill,  // [kRing / kFill] plans written
  kBarFree = kBarPlan + kRing / kFill,  // [kRing / kChunk] consumed
  kNumBars = kBarFree + kRing / kChunk
};

__host__ __device__ constexpr size_t r16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Dynamic shared memory, in bytes from its start.  ops/repair_cuda.py
// staging_plan mirrors `total`; the host entry checks that they agree.
struct SmemPlan {
  size_t ring, plans, tiles, log2, layout, probs, data, total;
};

__host__ __device__ inline SmemPlan smem_plan(int n, int PR, bool bytes_in) {
  SmemPlan p;
  p.ring = r16(sizeof(uint64_t) * kNumBars);
  p.plans = p.ring + sizeof(int4) * kRing;
  p.tiles = p.plans + sizeof(uint32_t) * 32 * kRing;
  p.log2 = p.tiles + sizeof(int) * 2 * kTileWords;
  p.layout = p.log2 + sizeof(int) * kLog2Words;
  p.probs = p.layout + r16(sizeof(int) * meg::kLayoutInts);
  p.data = p.probs + r16(sizeof(int) * size_t(PR));
  p.total = p.data + (bytes_in ? r16(size_t(n)) : 0);
  return p;
}

// ---- mbarriers and bulk copies (PTX) -----------------------------------

__device__ __forceinline__ uint32_t sa(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(sa(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(sa(b)), "r"(bytes) : "memory");
}
// With MEG_REPAIR_PROFILE (tools/profile_torch_iter.py) the waits spin
// on test_wait, so that every cycle a role waits is counted as waiting.
#ifdef MEG_REPAIR_PROFILE
#define MEG_WAIT_OP "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
#else
#define MEG_WAIT_OP "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
#endif
__device__ __forceinline__ bool bar_try(uint64_t* b, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      MEG_WAIT_OP
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(sa(b)), "r"(parity) : "memory");
  return ok != 0;
}
// wait for the completion of phase `parity` of barrier b; the cycles
// spent waiting
__device__ __forceinline__ long long bar_wait(uint64_t* b, uint32_t parity) {
  if (bar_try(b, parity)) return 0;
  const long long t0 = clock64();
  while (!bar_try(b, parity))
    if (clock64() - t0 > kWatchdog) __trap();
  return clock64() - t0;
}

#ifdef MEG_REPAIR_PROFILE
// per chain: walker cycles, walker waits, coster cycles, coster waits,
// records (packets + the end markers), first planner cycles and waits,
// then for the walker's lookahead: the long reps whose repair changed the
// old word's length (there a lookahead from the old word would miss; the
// walker issues a long rep's lookahead after the re-aim), and the packets
// whose successor lies past the tile (the lookahead stops at the edge)
constexpr int kProfileColumns = 9;
__device__ unsigned long long g_profile[1024][kProfileColumns];
#define MEG_PROFILE(...) __VA_ARGS__
#else
#define MEG_PROFILE(...)
#endif
// generic-proxy shared-memory accesses before, bulk copies after
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(sa(dst)), "l"(src), "r"(bytes), "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(sa(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

struct Args {
  const int32_t* slabs;     // [C, n] packed words
  const int32_t* qv;        // [C] repair start (unclipped)
  const int32_t* uv;        // [C] recording site
  const int32_t* mposv;     // [C] mutation site, -2 = none
  const int32_t* mut0;      // [C] word substituted at mpos
  const int32_t* mut1;      // [C] word at mpos + 1
  const uint8_t* data;      // [n] the block's bytes
  const int32_t* cand_d;    // [n, M]
  const int32_t* cand_l;    // [n, M]
  const int32_t* log2;      // [2048] exact cost table
  const int32_t* probs_in;  // [C, PR] snapshot probs
  const int32_t* carry_in;  // [C, 16] snapshot carry
  const int32_t* sc;        // [2] start_pos, cap_pos
  int32_t* out_slab;        // [C, n]
  int32_t* snap_probs;      // [C, PR]
  int32_t* snap_carry;      // [C, 16]
  int32_t* misc;            // [C, 9] hi lo rctx rd0-3 rlive pord
  int n, M, PR, lc, packet_sites, fb_match;
  meg::Layout L;
};

// ctx after a packet of each type (models/lzma_state.py ctx_next as a
// table, which tests/test_torch_repair.py checks; ctx < 12)
__constant__ unsigned char kCtxNext[4][12] = {
    {0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 4, 5},               // literal
    {7, 7, 7, 7, 7, 7, 7, 10, 10, 10, 10, 10},          // match
    {9, 9, 9, 9, 9, 9, 9, 11, 11, 11, 11, 11},          // short rep
    {8, 8, 8, 8, 8, 8, 8, 11, 11, 11, 11, 11}};         // long rep

// Walker state (replicated on the walker's lanes).
struct Carry {
  int ctx, d[4], live, since, rctx, rd[4], rlive;
};

// The flat index range [g0, g1) of int32 words, split into a 16-byte
// aligned body [a0, a1) for a bulk copy and the ragged words around it
// ([g0, h) and [t, g1)).  The buffers are 16-byte aligned at their base.
struct Span {
  size_t g0, g1, a0, a1, h, t;
  __device__ Span(size_t lo, size_t hi) : g0(lo), g1(hi) {
    a0 = (lo + 3) & ~size_t(3);
    a1 = hi & ~size_t(3);
    if (a1 <= a0) a0 = a1 = h = t = hi;   // no body: all ragged
    else { h = a0; t = a1; }
  }
  __device__ uint32_t body_bytes() const { return uint32_t(a1 - a0) * 4u; }
};

// A planner's lane j computes bit-plan slot j (the order and semantics of
// meg::plan_slot).  The lane's class is fixed, so its first row is read
// once; per packet every lane computes its group's row by selects, one
// instruction stream for the warp instead of one branch per slot group.
struct SlotLane {
  int grp;          // 0 header, 1 length choice, 2 length tree,
                    // 3 distance slot, 4 reverse tree, 5 none
  int k;            // level within the group
  int base;         // first packed row of the lane's class
  const int* rto;   // reverse-tree offsets of level k (group 4)
};

__device__ inline SlotLane slot_lane(int j, const meg::Layout& L) {
  SlotLane s{5, 0, 0, L.rt_off[0]};
  if (j < 5) {
    const int cls = j == 0 ? meg::kIsMatch : j == 1 ? meg::kIsRep
                    : j == 2 ? meg::kG0 : j == 3 ? meg::kG1R0L : meg::kG2;
    s = {0, j, L.row[cls], s.rto};
  }
  else if (j < 7) s = {1, j - 5, L.row[meg::kLch], s.rto};
  else if (j < 15) s = {2, j - 7, L.row[meg::kLtree0 + j - 7], s.rto};
  else if (j < 21) s = {3, j - 15, L.row[meg::kDst0 + j - 15], s.rto};
  else if (j < 26) s = {4, j - 21, L.row[meg::kRt0 + j - 21], L.rt_off[j - 21]};
  return s;
}

// Slot of a MATCH, SREP or LREP packet: whether it is coded, its row and
// bit, and (for lane 0) the direct bits.
__device__ __forceinline__ bool nonlit_slot(const SlotLane& sl, int type,
                                            int dist, int len, int ctx,
                                            int* row, int* bit, int* ndir) {
  const bool match = type == meg::kMatch, lrep = type == meg::kLrep;
  const bool rep = type >= meg::kSrep, coded_len = match || lrep;
  const bool b3 = lrep && dist != 0;
  const int b4 = b3 ? int(dist != 1) : int(lrep);
  const int len2 = max(len - 2, 0);
  const int c1 = len2 >= 8, c2 = len2 >= 16, repc = lrep;
  const int nlb_t = max(32 - __clz(dist) - 2, 0);
  const int ps = dist < 4 ? dist : nlb_t * 2 + (dist >> nlb_t);
  const int k = sl.k;
  // header: is_match, is_rep, g0, g1 / rep0-long, g2
  const int h_off = ctx + ((k == 3 && !b3) ? 12 : 0);
  const int h_bit = k == 0 ? 1 : k == 1 ? int(rep) : k == 2 ? int(b3)
                    : k == 3 ? b4 : int(dist != 2);
  const bool h_act = k <= 1 || (k <= 3 ? rep : rep && b3 && b4 == 1);
  // length choice bits
  const int c_off = 2 * k + repc, c_bit = k == 0 ? c1 : c2;
  const bool c_act = coded_len && (k == 0 || c1);
  // length tree level k
  const int nbits = c2 ? 8 : 3;
  const int tval = !c1 ? len2 : (!c2 ? len2 - 8 : len2 - 16);
  const int tsel = k < 3 ? (c2 ? 4 + repc : repc * 2 + c1) : repc;
  const int t_off = (tsel << k) + (tval >> max(nbits - k, 0));
  const int t_bit = (tval >> max(nbits - 1 - k, 0)) & 1;
  const bool t_act = coded_len && k < nbits;
  // distance slot tree level k
  const int d_off = (min(len2, 3) << k) + (ps >> max(6 - k, 0));
  const int d_bit = (ps >> max(5 - k, 0)) & 1;
  // reverse tree level k
  const bool mid = ps < 14;
  const int nlb = mid ? max((ps >> 1) - 1, 0) : 4;
  const bool r_act = match && ps >= 4 && k < nlb;
  const int low = dist & ((1 << nlb) - 1);
  const int rev = k ? int(__brev(uint32_t(low)) >> (32 - k)) : 0;
  const int r_off = (r_act ? sl.rto[mid ? ps - 4 : 10] : 0) + rev;
  const int r_bit = (low >> k) & 1;

  const int g = sl.grp;
  *row = sl.base + (g == 0 ? h_off : g == 1 ? c_off : g == 2 ? t_off
                    : g == 3 ? d_off : r_off);
  *bit = g == 0 ? h_bit : g == 1 ? c_bit : g == 2 ? t_bit
         : g == 3 ? d_bit : r_bit;
  *ndir = (match && ps >= 14) ? nlb_t - 4 : 0;
  return g == 0 ? h_act : g == 1 ? c_act : g == 2 ? t_act
         : g == 3 ? match : g == 4 && r_act;
}

template <bool kBytesInSmem>
__global__ void __launch_bounds__(kThreads, 1)
repair_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, PR = a.PR;
  const SmemPlan sp = smem_plan(n, PR, kBytesInSmem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + sp.ring);
  uint32_t* plans = reinterpret_cast<uint32_t*>(smem + sp.plans);
  int* tiles = reinterpret_cast<int*>(smem + sp.tiles);
  int* log2s = reinterpret_cast<int*>(smem + sp.log2);
  meg::Layout& L = *reinterpret_cast<meg::Layout*>(smem + sp.layout);
  int* probs = reinterpret_cast<int*>(smem + sp.probs);
  uint8_t* bytes_s = smem + sp.data;

  const int c = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int start = min(max(a.sc[0], 0), n), cap = a.sc[1];
  const int ntiles = (n - start + kTile - 1) / kTile;
  const size_t row = size_t(c) * n;       // the chain's row, flat
  const int off = int((row + start) & 3); // quad offset of every tile

  if (tid == 0) {
    bar_init(&bars[kBarInit], 1);
    for (int k = 0; k < 2; ++k) {
      bar_init(&bars[kBarTma + k], 1);
      bar_init(&bars[kBarReady + k], 32);
      bar_init(&bars[kBarDone + k], 1);
    }
    for (int k = 0; k < kRing / kFill; ++k) {
      bar_init(&bars[kBarFull + k], 1);
      bar_init(&bars[kBarPlan + k], kPlanners);
    }
    for (int k = 0; k < kRing / kChunk; ++k) bar_init(&bars[kBarFree + k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint32_t body_n = kBytesInSmem ? uint32_t(n) & ~15u : 0u;
  if (tid == 0) {
    bar_expect(&bars[kBarInit], uint32_t(sizeof(int)) * (kLog2Words + PR)
                                    + body_n);
    bulk_load(log2s, a.log2, sizeof(int) * kLog2Words, &bars[kBarInit]);
    bulk_load(probs, a.probs_in + size_t(c) * PR, sizeof(int) * PR,
              &bars[kBarInit]);
    if (body_n) bulk_load(bytes_s, a.data, body_n, &bars[kBarInit]);
  }
  const int* lsrc = reinterpret_cast<const int*>(&a.L);
  for (int k = tid; k < meg::kLayoutInts; k += kThreads)
    reinterpret_cast<int*>(&L)[k] = lsrc[k];
  if (kBytesInSmem)
    for (int k = int(body_n) + tid; k < n; k += kThreads) bytes_s[k] = a.data[k];
  __syncthreads();

  // Warp w issues on scheduler w % 4: the walker, the coster and the
  // first planner each have one to themselves, and the second planner
  // shares the stager's, which mostly waits.
  if (warp == 0) {
    // ---------------- stager ----------------
    const int mpos = a.mposv[c];
    const int32_t m0 = a.mut0[c], m1 = a.mut1[c];
    auto tile_span = [&](int k) {
      const int b = start + k * kTile;
      return Span(row + b, row + min(b + kTile, n));
    };
    auto stage = [&](int k) {
      int* buf = tiles + (k & 1) * kTileWords + off;   // buf[g - g0]
      const Span s = tile_span(k);
      if (lane == 0) {
        fence_async();
        if (s.a1 > s.a0) {
          bar_expect(&bars[kBarTma + (k & 1)], s.body_bytes());
          bulk_load(buf + (s.a0 - s.g0), a.slabs + s.a0, s.body_bytes(),
                    &bars[kBarTma + (k & 1)]);
        } else {
          bar_arrive(&bars[kBarTma + (k & 1)]);
        }
      }
      for (size_t g = s.g0 + lane; g < s.h; g += 32) buf[g - s.g0] = a.slabs[g];
      for (size_t g = s.t + lane; g < s.g1; g += 32) buf[g - s.g0] = a.slabs[g];
      bar_wait(&bars[kBarTma + (k & 1)], (k >> 1) & 1);
      __syncwarp();
      const int b = start + k * kTile;
      for (int i = lane; i < int(s.g1 - s.g0); i += 32) {
        int32_t w = buf[i];
        if (b + i == mpos) w = m0;
        else if (b + i == mpos + 1) w = m1;
        buf[i] = int32_t(uint32_t(w) & ~meg::kLiveBit);
      }
      fence_async();
      bar_arrive(&bars[kBarReady + (k & 1)]);
    };
    auto store = [&](int k) {
      bar_wait(&bars[kBarDone + (k & 1)], (k >> 1) & 1);
      const int* buf = tiles + (k & 1) * kTileWords + off;
      const Span s = tile_span(k);
      if (lane == 0 && s.a1 > s.a0) {
        fence_async();
        bulk_store(a.out_slab + s.a0, buf + (s.a0 - s.g0), s.body_bytes());
      }
      for (size_t g = s.g0 + lane; g < s.h; g += 32) a.out_slab[g] = buf[g - s.g0];
      for (size_t g = s.t + lane; g < s.g1; g += 32) a.out_slab[g] = buf[g - s.g0];
      if (lane == 0) bulk_wait_read();   // the buffer may be reloaded
      __syncwarp();
    };
    for (int k = 0; k < min(ntiles, 2); ++k) stage(k);
    {   // the unwalked prefix passes through verbatim
      const Span s(row, row + start);
      for (size_t g = s.g0 + lane; g < s.h; g += 32) a.out_slab[g] = a.slabs[g];
      for (size_t g = s.t + lane; g < s.g1; g += 32) a.out_slab[g] = a.slabs[g];
      const int4* src = reinterpret_cast<const int4*>(a.slabs + s.a0);
      int4* dst = reinterpret_cast<int4*>(a.out_slab + s.a0);
      const int nv = int((s.a1 - s.a0) >> 2);
#pragma unroll 8
      for (int i = lane; i < nv; i += 32) dst[i] = src[i];
    }
    for (int k = 2; k < ntiles; ++k) {
      store(k - 2);
      stage(k);
    }
    for (int k = max(ntiles - 2, 0); k < ntiles; ++k) store(k);
    if (lane == 0) bulk_wait_all();
    return;
  }

  bar_wait(&bars[kBarInit], 0);
  const int lc = a.lc;

  if (warp >= 3) {
    // ---------------- planners ----------------
    // each record's bit plan, one word a lane: slot j's row (bits 0-13),
    // bit (14), whether it is coded (15), on lane 0 the direct bits
    // (16-23), and the record's marks (24-27, every lane; an end record's
    // plan is its marks alone).  Planner w plans the records of parity
    // w - 3 and publishes its half of each chunk; the walker ends the ring
    // with one end record per planner.
    const int par = warp - 3;
    MEG_PROFILE(long long waited = 0; const long long t0 = clock64();)
    const SlotLane sl = slot_lane(lane, L);
    const int lit_k = min(max(lane - 5, 0), 7);       // literal bit lanes
    const bool lit_act = lane == 0 || (lane >= 5 && lane < 13);
    const int match_row = L.row[meg::kIsMatch], lit_base = L.row[meg::kLitCls];
    for (int i = par;; i += kPlanners) {
      const int slot = i % kRing;
      if (slot % kFill == par)
        MEG_PROFILE(waited +=)
            bar_wait(&bars[kBarFull + slot / kFill], (i / kRing) & 1);
      const int4 r = ring[slot];
      const uint32_t meta = uint32_t(r.z);
      if ((meta >> 28) & kEndFlag) {     // pass the end on
        plans[slot * 32 + lane] = (meta >> 28) << 24;
        __syncwarp();
        if (lane == 0) {
          bar_arrive(&bars[kBarPlan + slot / kFill]);
          MEG_PROFILE(if (par == 0) {
                        g_profile[c][5] = clock64() - t0;
                        g_profile[c][6] = waited;
                      })
        }
        return;
      }
      const meg::Packet p = meg::unpack(uint32_t(r.y));
      const int ctx = meta & 15, byte = (meta >> 4) & 255;
      const int mb = (meta >> 12) & 255, prev = (meta >> 20) & 255;
      int row, bit, ndir = 0;
      bool act;
      if (p.type == meg::kLit) {         // slot 0 and the 8 literal bits
        const int k = lit_k;
        const int sym = (1 << k) | (byte >> (8 - k));
        const int mbit = (mb >> (7 - k)) & 1;
        // matched mode holds while the match byte agrees on bits above k
        const bool prefix_eq = ((byte ^ mb) >> (8 - k)) == 0;
        const int sel = (ctx >= 7 && prefix_eq) ? 1 + mbit : 0;
        const int lit_row0 = lit_base + (lc ? (prev >> (8 - lc)) * 0x300 : 0);
        row = lane == 0 ? match_row + ctx : lit_row0 + sym + (sel << 8);
        bit = lane == 0 ? 0 : (byte >> (7 - k)) & 1;
        act = lit_act;
      } else {
        act = nonlit_slot(sl, p.type, p.dist, p.len, ctx, &row, &bit, &ndir);
      }
      plans[slot * 32 + lane] =
          (meta >> 28) << 24 | uint32_t(ndir) << 16
          | (act ? uint32_t(row) | uint32_t(bit) << 14 | 1u << 15 : 0u);
      if (slot % kFill == kFill - kPlanners + par) {   // publish the half
        __syncwarp();
        if (lane == 0) bar_arrive(&bars[kBarPlan + slot / kFill]);
      }
    }
  }

  if (warp == 2) {
    // ---------------- coster ----------------
    const int32_t* ci = a.carry_in + size_t(c) * 16;
    const int hi0 = ci[6], lo0 = ci[7];
    long long acc = 0;                   // this lane's slots, since start
    MEG_PROFILE(long long waited = 0; const long long t0 = clock64();)
    // (hi, lo) after the first `packets` packets, normalised as the
    // reference's per-packet carry leaves it
    auto hilo = [&](int packets, int* hi, int* lo) {
      const long long tot = meg::warp_sum64(acc);
      if (packets == 0) { *hi = hi0; *lo = lo0; return; }
      const long long v = (long long)hi0 * 65536 + lo0 + tot;
      *hi = int(v >> 16);
      *lo = int(v & 0xFFFF);
    };
    for (int i = 0;; ++i) {
      const int slot = i % kRing;
      if (slot % kFill == 0)
        MEG_PROFILE(waited +=)
            bar_wait(&bars[kBarPlan + slot / kFill], (i / kRing) & 1);
      const uint32_t w = plans[slot * 32 + lane];
      const uint32_t flags = (w >> 24) & 15;
      if (flags & kCapFlag) {            // state entering this packet
        int hi, lo;
        hilo(i, &hi, &lo);
        __syncwarp();
        for (int k = lane; k < PR; k += 32)
          a.snap_probs[size_t(c) * PR + k] = probs[k];
        if (lane == 0) {
          a.snap_carry[size_t(c) * 16 + 6] = hi;
          a.snap_carry[size_t(c) * 16 + 7] = lo;
        }
        __syncwarp();
      }
      if (flags & kEndFlag) {
        int hi, lo;
        hilo(i, &hi, &lo);
        if (lane == 0) {
          a.misc[size_t(c) * 9 + 0] = hi;
          a.misc[size_t(c) * 9 + 1] = lo;
          MEG_PROFILE(g_profile[c][2] = clock64() - t0;
                      g_profile[c][3] = waited;)
        }
        break;
      }
      const int row = w & 0x3FFF, bit = (w >> 14) & 1;
      const bool act = (w >> 15) & 1;
      if (lane == 0) acc += int((w >> 16) & 0xFF) << meg::kProbBits;
      if (act) {
        const int pr = probs[row];
        acc += log2s[meg::cost_index(pr, bit)];
        probs[row] = meg::adapt(pr, bit);
      }
      if ((i + 1) % kChunk == 0) {       // release the chunk to the walker
        __syncwarp();
        if (lane == 0) bar_arrive(&bars[kBarFree + slot / kChunk]);
      }
    }
    return;
  }

  // ---------------- walker (warp 1) ----------------
  const int q = a.qv[c], u = a.uv[c];
  const int M = a.M;
  auto byte_at = [&](int i) -> int {
    return kBytesInSmem ? bytes_s[i] : __ldg(a.data + i);
  };
  const int32_t* ci = a.carry_in + size_t(c) * 16;
  Carry s;
  s.ctx = ci[0];
  for (int k = 0; k < 4; ++k) s.d[k] = ci[1 + k];
  s.live = ci[5]; s.since = ci[8]; s.rctx = ci[9];
  for (int k = 0; k < 4; ++k) s.rd[k] = ci[10 + k];
  s.rlive = ci[14];
  const int pord0 = ci[15];              // the packet ordinal is pord0 + nrec

  int nrec = 0;                          // records handed on
  MEG_PROFILE(long long waited = 0, misses = 0, edges = 0;
              const long long t0 = clock64();)
  uint32_t pend = 0;                     // flags for the next record
  // The ring is published kFill records at a time, and once more after
  // the last record.  Before a chunk's first slot is written again, the
  // coster must have released it: the walker waits for that right after
  // publishing the chunk before it.
  auto emit = [&](int pos, uint32_t word, uint32_t meta, bool last) {
    const int slot = nrec & (kRing - 1);
    // every lane stores the one value: no lane test on the hot path
    ring[slot] = make_int4(pos, int(word), int(meta | (pend << 28)), 0);
    pend = 0;
    ++nrec;
    if ((nrec & (kFill - 1)) == 0 || last) {
      if (lane == 0) bar_arrive(&bars[kBarFull + slot / kFill]);
      if (!last && (nrec & (kChunk - 1)) == 0 && nrec >= kRing)
        MEG_PROFILE(waited +=)
            bar_wait(&bars[kBarFree + (nrec & (kRing - 1)) / kChunk],
                     ((nrec / kRing) - 1) & 1);
    }
  };

  bool captured = false;
  bool rec_pending = !a.packet_sites && u >= start && u < n;
  auto record = [&]() {
    s.rctx = s.ctx;
    for (int k = 0; k < 4; ++k) s.rd[k] = s.d[k];
    s.rlive = s.live;
  };
  auto capture = [&]() {                 // state entering position cap
    if (lane == 0) {
      int32_t* o = a.snap_carry + size_t(c) * 16;
      o[0] = s.ctx;
      for (int k = 0; k < 4; ++k) o[1 + k] = s.d[k];
      o[5] = s.live;
      o[8] = 0;                          // `since` is pass-relative
      o[9] = s.rctx;
      for (int k = 0; k < 4; ++k) o[10 + k] = s.rd[k];
      o[14] = s.rlive; o[15] = pord0 + nrec;
    }
    pend |= kCapFlag;                    // the coster adds probs, hi, lo
    captured = true;
  };
  // before the packet at position P (P = INT_MAX: after the last one):
  // sites before the capture point record first, the capture sees them
  auto prologue = [&](int P) {
    if (rec_pending && u < cap && P >= u) { record(); rec_pending = false; }
    if (!captured && P >= cap) capture();
    if (rec_pending && P >= u) { record(); rec_pending = false; }
  };
  // the first position at which the prologue has work to do
  auto next_event = [&]() {
    return min(rec_pending ? u : 0x7fffffff, captured ? 0x7fffffff : cap);
  };
  int next_ev = next_event();
  const int usite = a.packet_sites ? u : -1;   // packet ordinal to record at
  // The one test a packet makes for both kinds of event: the first
  // position at which one can fall.  A packet advances the walk by one
  // position or more, so the packet site `left` packets ahead lies at
  // least `left` positions ahead.
  auto check_from = [&](int pos, int left) {
    return left >= 0 ? min(next_ev, pos + min(left, n)) : next_ev;
  };
  int chk = check_from(s.live, usite - pord0);

  // One-packet lookahead.  The next packet starts at pos + this packet's
  // length and sees the rep0 this packet leaves; both are known before
  // the packet's record is built (at once for a literal, a short rep or a
  // match, whose length the repair keeps or sets to 1; after the re-aim
  // for a long rep).  The loads of the next packet (its word, byte,
  // previous byte and match byte) are issued there, and settle into
  // plain values (`nx`) at the end of the packet, while the record, the
  // live word and the transitions are done: so the next packet finds
  // them arrived, and no load is still pending when it issues its own
  // (the card's few scoreboards would otherwise make it wait on them).
  // The lookahead stays inside the tile: the next tile's words are read
  // only after its kBarReady.
  uint32_t lw = 0;                       // the loads in flight
  int lb = 0, lp = 0, lm = 0;
  meg::Packet nx{0, 0, 0};               // settled: the next word's fields,
  uint32_t nx_bytes = 0;                 // byte << 4 | match byte << 12
  bool nx_eq = false;                    //   | previous byte << 20; mb == byte
  auto settle = [&]() {
    nx = meg::unpack(lw);
    nx_bytes = uint32_t(lb) << 4 | uint32_t(lm) << 12 | uint32_t(lp) << 20;
    nx_eq = lm == lb;
  };

  bool stuck = s.live < start;           // contract: live >= start
  for (int k = 0; k < ntiles; ++k) {
    const int b = start + k * kTile;
    // held in a register (a shuffle's result): else the compiler
    // recomputes it in the loop below, from a constant load of n
    const int e = __shfl_sync(kFullMask, min(b + kTile, n), 0);
    int* wb = tiles + (k & 1) * kTileWords + off - b;   // wb[pos]
    // the loads of the packet at `at`, which sees rep0 d0 (a position
    // past the tile loads the tile's last one: the walk leaves the tile
    // there, and they go unused)
    auto load_next = [&](int at, int d0) {
      at = min(at, e - 1);
      lw = uint32_t(wb[at]);
      lb = byte_at(at);
      lp = (lc && at > 0) ? byte_at(at - 1) : 0;
      lm = byte_at(min(max(at - d0 - 1, 0), n - 1));
    };
    MEG_PROFILE(waited +=) bar_wait(&bars[kBarReady + (k & 1)], (k >> 1) & 1);
    if (!stuck && s.live < e) {
      load_next(s.live, s.d[0]);
      settle();
      do {
        const int pos = s.live;
        if (__builtin_expect(pos >= chk, 0)) {
          if (pos >= next_ev) {
            prologue(pos);
            next_ev = next_event();
          }
          const int left = usite - (pord0 + nrec);
          if (left == 0) record();
          chk = check_from(pos + 1, left - 1);
        }
        meg::Packet p = nx;
        const uint32_t bytes = nx_bytes;
        const bool in_repair = pos >= q;
        const bool srep_ok = pos > 0 && s.d[0] + 1 <= pos && nx_eq;
        const bool count_ok = s.since < 4;
        // Each kind of packet issues the next one's loads as soon as it
        // knows its own length and the rep0 it leaves.
        if (!(p.type & 1)) {             // a literal or a short rep
          if (in_repair) {               // re-typed, with length 1
            p.type = (srep_ok && count_ok) ? meg::kSrep
                     : (srep_ok ? p.type : meg::kLit);
            p.dist = 0;
            p.len = 1;
          }
          load_next(pos + p.len, s.d[0]);
        } else if (p.type == meg::kMatch) {
          load_next(pos + p.len, p.dist);
          s.d[3] = s.d[2]; s.d[2] = s.d[1]; s.d[1] = s.d[0]; s.d[0] = p.dist;
        } else {                         // a long rep
          if (in_repair) {
            // re-aim against the live stack: valid = the stack distance
            // is in this position's candidate row with enough extension;
            // under the match fallback, the lane's longest entry and its
            // nearest distance on ties.
            const int old_len = p.len;
            const int32_t* cdr = a.cand_d + size_t(pos) * M;
            const int32_t* clr = a.cand_l + size_t(pos) * M;
            int cd0 = 0, cl0 = -1, cd1 = 0, cl1 = -1;
            if (lane < M) { cd0 = cdr[lane]; cl0 = clr[lane]; }
            if (lane + 32 < M) { cd1 = cdr[lane + 32]; cl1 = clr[lane + 32]; }
            const bool fb = a.fb_match;
            unsigned hit = 0;            // bit j: stack entry j found
            int ml = -1, dmin = 1 << 30;
            auto scan = [&](int cd, int cl) {
              for (int j = 0; j < 4; ++j)
                hit |= unsigned(cd == s.d[j] && cl >= p.len) << j;
              if (fb) {
                if (cl > ml) { ml = cl; dmin = cd; }
                else if (cl == ml) dmin = min(dmin, cd);
              }
            };
            if (lane < M) scan(cd0, cl0);
            if (lane + 32 < M) scan(cd1, cl1);
            for (int m = lane + 64; m < M; m += 32) scan(cdr[m], clr[m]);
            hit = __reduce_or_sync(kFullMask, hit);
            bool valid[4];
            for (int j = 0; j < 4; ++j)
              valid[j] = ((hit >> j) & 1) && s.d[j] + 1 <= pos;
            const int cur = min(max(p.dist, 0), 3);
            const bool cur_ok = cur == 0 ? valid[0] : cur == 1 ? valid[1]
                                : cur == 2 ? valid[2] : valid[3];
            const bool any = valid[0] || valid[1] || valid[2] || valid[3];
            const int first = valid[0] ? 0
                              : (valid[1] ? 1 : (valid[2] ? 2 : 3));
            int bd = 0, flen = 0;
            bool use_m = false;
            if (fb) {                    // longest table match, nearest on ties
              const int wml = __reduce_max_sync(kFullMask, ml);
              bd = __reduce_min_sync(kFullMask, ml == wml ? dmin : 1 << 30);
              flen = min(wml, n - pos);
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
            MEG_PROFILE(misses += p.len != old_len;)
          }
          meg::dists_next(s.d, p.type, p.dist);
          load_next(pos + p.len, s.d[0]);
        }
        MEG_PROFILE(edges += pos + p.len >= e && pos + p.len < n;)
        const uint32_t word = meg::pack_live(p);
        emit(pos, word, uint32_t(s.ctx) | bytes, false);
        wb[pos] = int32_t(word);           // every lane, one value
        s.ctx = kCtxNext[p.type][s.ctx];
        s.live = pos + p.len;
        s.since += in_repair;
        stuck = p.len == 0;                // a zero-length packet ends the walk
        settle();
      } while (!stuck && s.live < e);
    }
    __syncwarp();
    if (lane == 0) {
      fence_async();                     // the live words go out by bulk copy
      bar_arrive(&bars[kBarDone + (k & 1)]);
    }
  }
  prologue(0x7fffffff);
  if (!captured) capture();
  const int npackets = nrec;
  for (int k = 0; k < kPlanners; ++k) {   // an end for each planner
    pend |= kEndFlag;
    emit(0, 0, 0, k == kPlanners - 1);
  }
  if (lane == 0) {
    MEG_PROFILE(g_profile[c][0] = clock64() - t0; g_profile[c][1] = waited;
                g_profile[c][4] = nrec;
                g_profile[c][7] = misses; g_profile[c][8] = edges;)
    int32_t* o = a.misc + size_t(c) * 9;
    o[2] = s.rctx;
    for (int k = 0; k < 4; ++k) o[3 + k] = s.rd[k];
    o[7] = s.rlive; o[8] = pord0 + npackets;
  }
}

}  // namespace

#ifdef MEG_REPAIR_PROFILE
extern "C" int meg_repair_profile(unsigned long long* out) {   // [1024][9]
  return int(cudaMemcpyFromSymbol(out, g_profile, sizeof(g_profile)));
}
extern "C" int meg_repair_profile_columns() { return kProfileColumns; }
#endif

extern "C" int meg_repair(
    const int32_t* slabs, const int32_t* q, const int32_t* u,
    const int32_t* mpos, const int32_t* mut0, const int32_t* mut1,
    const uint8_t* data, const int32_t* cand_d, const int32_t* cand_l,
    const int32_t* log2, const int32_t* probs_in, const int32_t* carry_in,
    const int32_t* sc, int32_t* out_slab, int32_t* snap_probs,
    int32_t* snap_carry, int32_t* misc, int C, int n, int M, int PR, int lc,
    int packet_sites, int fb_match, int bytes_in_smem, int smem_bytes,
    const int32_t* layout, cudaStream_t stream) {
  Args a{slabs, q, u, mpos, mut0, mut1, data, cand_d, cand_l, log2,
         probs_in, carry_in, sc, out_slab, snap_probs, snap_carry, misc,
         n, M, PR, lc, packet_sites, fb_match, {}};
  for (int k = 0; k < meg::kNumCls; ++k) a.L.row[k] = layout[k];
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 11; ++k)
      a.L.rt_off[t][k] = layout[meg::kNumCls + t * 11 + k];
  const size_t smem = smem_plan(n, PR, bytes_in_smem != 0).total;
  if (smem != size_t(smem_bytes) || PR > (1 << 14))   // rows fit 14 bits
    return int(cudaErrorInvalidValue);
  cudaError_t err;
  if (bytes_in_smem) {
    err = meg::allow_smem(repair_kernel<true>, smem);
    if (err != cudaSuccess) return int(err);
    repair_kernel<true><<<C, kThreads, smem, stream>>>(a);
  } else {
    err = meg::allow_smem(repair_kernel<false>, smem);
    if (err != cudaSuccess) return int(err);
    repair_kernel<false><<<C, kThreads, smem, stream>>>(a);
  }
  return int(cudaGetLastError());
}
