// Kernel 3: the proposal stage of one anneal iteration, in one launch.
//
// Replaces megalania_tpu/ops/pallas_rank.py::_kernel (wrapper
// rank_pallas), the candidate ranking, and takes in with it everything
// of the iteration that the ranking's inputs and outputs touch and that
// does not read the repair pass: the key schedule, candidate
// enumeration, the biased top-K choice and boundary moves, the
// recording-site draw and the acceptance draw.  jax.random is counter
// based, so all of it can run before the repair kernel.  Same results as
// the plain version, megalania_tpu_torch/ops/propose_cuda.py::
// propose_plain (the torch sequence of the engine: utils/threefry.py,
// anneal/moves.py, rank_plain):
//
//   key_next [Cn] (int64 pairs), skey_next, v0/v1 (the two mutated
//   cells), u (the recording site) per row, acc_u per chain (float32),
//   metric [rows, NC] (cost // max(len, 1), BIG where invalid).
//
// Rows are chains x proposals (row r reads chain r / Pn).  The literal
// candidate is costed here too (the TPU kernel left it to XLA).
//
// What bounds it on Hopper: the bytes are the chains' probabilities
// (~7 KB a row at lc=0) and a few gathers, well under a microsecond of
// HBM time; the work is ~62 candidates x 26 slots of shared-memory
// gathers and float32 log2 per row plus ~35 threefry hashes, all short
// dependent chains.  So it is latency: one block per row, the row's
// probabilities in shared memory, two warps that enumerate and rank one
// candidate a lane while a third hashes the row's keys (each lane walks
// its own short chain of splits to one draw, so the hashes run side by
// side), then an order statistic (a count of smaller keys per candidate,
// no sort) picks the chosen candidate.

#include "meg_cost.cuh"
#include "threefry.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMatchLenMin = 2, kMatchLenMax = 273;
constexpr int kRankThreads = 64;                 // warps 0-1: candidates
constexpr int kThreads = kRankThreads + 32;      // warp 2: keys
constexpr int kBiasDraws = 8;

// the key warp's words in shared memory
enum {
  kHigher = 0,            // 8 draws' high words
  kLower = 8,             // 8 draws' low words
  kCoin = 16, kForced, kSiteHi, kSiteLo, kAcc,
  kKeyNext = 21,          // 2 words
  kSkeyNext = 23,         // 2 words
  kKeyWords = 25
};

struct Args {
  const int64_t* keys;        // [Cn, 2] chain keys (uint32 words)
  const int64_t* skey;        // [2] the block's shared key
  const int32_t* slab;        // [Cn, n]
  const int32_t* q;           // [Cn] mutation sites        (row stride sq)
  const int32_t* rec_ctx;     // [Cn]                       (sctx)
  const int32_t* rec_dists;   // [Cn, 4]                    (sdists)
  const int32_t* probs;       // [Cn, PR] class-packed ranking state
  const int32_t* live_count;  // [Cn] (packet sites)        (slive)
  const int32_t* data;        // [n]
  const int32_t* rank;        // [n]
  const int32_t* sparse;      // [K, n]
  const int32_t* cand_dist;   // [n, M]
  const int32_t* cand_len;    // [n, M]
  const int32_t* cand_count;  // [n]
  const int32_t* corr;        // [128]
  int64_t* key_next;          // [Cn, 2]
  int64_t* skey_next;         // [2]
  int32_t* v0;                // [rows]
  int32_t* v1;                // [rows]
  int32_t* u;                 // [rows]
  float* acc_u;               // [Cn]
  int32_t* metric;            // [rows, NC]
  int Pn, n, M, NC, SL, top_k, PR, lc;
  int site_mode;              // 0: u_lo + [0, span); 1: packet ordinals
  int u_lo, span;
  int sq, sctx, sdists, slive;  // row strides (views of the repair outputs)
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ uint32_t pack_word(int type, int dist, int len) {
  return (uint32_t(dist) & 0xFFFFFu) | ((uint32_t(len) & 0x1FFu) << 20) |
         ((uint32_t(type) & 3u) << 29);
}

// moves._sublens: candidate length j of an entry of maximal length m
__device__ __forceinline__ int sublen(int j, int m) {
  switch (j) {
    case 0: return m;
    case 1: return max(m * 2 / 3, 2);
    case 2: return 2;
    case 3: return max(m - 1, 2);
    case 4: return max(m - 2, 2);
    case 5: return max(m * 3 / 4, 2);
    case 6: return max(m / 2, 2);
    case 7: return max(m / 3, 2);
    case 8: return max(m - 3, 2);
    default: return 3;
  }
}

// ... and its keep mask: no earlier length of the entry is the same
__device__ __forceinline__ bool sublen_kept(int j, int m) {
  const int l = sublen(j, m);
  bool keep = true;
  for (int jj = 0; jj < j; ++jj) keep = keep && sublen(jj, m) != l;
  return keep;
}

// match/suffix.py lce: longest common extension of positions a and b
__device__ __forceinline__ int lce(const Args& A, int a, int b) {
  if (a == b) return A.n - a;
  const int ra = A.rank[a], rb = A.rank[b];
  const int lo = min(ra, rb) + 1, hi = max(ra, rb) + 1;
  const int k = 31 - __clz(max(hi - lo, 1));
  const int32_t* row = A.sparse + size_t(k) * A.n;
  return min(row[lo], row[hi - (1 << k)]);
}

// Candidate k of the set at the clipped site qc (moves.gather_candidates
// order: literal, short rep, SL x 4 long reps, SL x M table matches),
// minus the incumbent packet: its packed word, live bit = valid.
__device__ uint32_t candidate(const Args& A, int k, int qc, const int d[4],
                              const meg::Packet& cur) {
  const int n = A.n;
  int type, dist, len;
  bool valid;
  if (k < 2) {
    type = k == 0 ? meg::kLit : meg::kSrep;
    dist = 0;
    len = 1;
    valid = k == 0 || (qc > 0 && qc >= d[0] + 1 &&
                       A.data[qc] == A.data[clampi(qc - d[0] - 1, 0, n - 1)]);
  } else if (k < 2 + 4 * A.SL) {
    const int j = (k - 2) >> 2, s = (k - 2) & 3;
    const int ds = s == 0 ? d[0] : s == 1 ? d[1] : s == 2 ? d[2] : d[3];
    int ext = min(lce(A, qc, clampi(qc - ds - 1, 0, n - 1)), kMatchLenMax);
    ext = ds + 1 <= qc ? ext : 0;
    type = meg::kLrep;
    dist = s;
    len = sublen(j, ext);
    valid = sublen_kept(j, ext) && ext >= kMatchLenMin && len <= ext;
  } else {
    const int i = k - 2 - 4 * A.SL, j = i / A.M, m = i % A.M;
    const size_t at = size_t(qc) * A.M + m;
    const int row_l = A.cand_len[at];
    type = meg::kMatch;
    dist = A.cand_dist[at];
    len = sublen(j, row_l);
    valid = sublen_kept(j, row_l) && m < A.cand_count[qc] &&
            len >= kMatchLenMin && len <= row_l;
  }
  valid = valid && !(type == cur.type && dist == cur.dist && len == cur.len);
  return pack_word(type, dist, len) | (valid ? meg::kLiveBit : 0u);
}

// The key warp: lane L hashes the chain of splits that ends in word L of
// the kKey* table (each chain is at most six hashes deep).
__device__ void key_words(const Args& A, int c, int p, int lane,
                          uint32_t* words) {
  if (lane > 22) return;
  uint32_t head, t[4] = {0, 0, 0, 0};
  int len = 0;
  bool use_p = A.Pn > 1;
  if (lane < 16) {                 // kprop, ks[1], kk[0], split -> bits
    head = 1; t[0] = 1; t[1] = 0; t[2] = lane >> 3; t[3] = lane & 7; len = 4;
  } else if (lane == kCoin) {      // kprop, ks[0] -> bits
    head = 1; t[0] = 0; t[1] = 0; len = 2;
  } else if (lane == kForced) {    // kprop, ks[1], kk[1] -> bits
    head = 1; t[0] = 1; t[1] = 1; t[2] = 0; len = 3;
  } else if (lane == kSiteHi || lane == kSiteLo) {   // ku, split -> bits
    head = 2; t[0] = lane - kSiteHi; t[1] = 0; len = 2;
  } else if (lane == kAcc) {       // kacc -> bits
    head = 3; t[0] = 0; len = 1; use_p = false;
  } else {                         // key_next, skey_next
    head = 0; use_p = false;
  }
  const int64_t* src = lane == 22 ? A.skey : A.keys + 2 * c;
  tf::Key k = {uint32_t(src[0]), uint32_t(src[1])};
  k = tf::split(k, head);
  if (use_p) k = tf::split(k, uint32_t(p));
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < len) k = tf::split(k, t[s]);
  if (lane <= kAcc) {
    words[lane] = k.a ^ k.b;
  } else {
    const int at = lane == 21 ? kKeyNext : kSkeyNext;
    words[at] = k.a;
    words[at + 1] = k.b;
  }
}

__global__ void __launch_bounds__(kThreads) propose_kernel(Args A,
                                                           meg::Layout L) {
  extern __shared__ int smem[];
  int* pr = smem;                              // [PR]
  int* corr_s = pr + A.PR;                     // [128]
  uint32_t* cand_s = reinterpret_cast<uint32_t*>(corr_s + meg::kCorrWords);
  int* met_s = reinterpret_cast<int*>(cand_s + A.NC);   // [NC]
  uint32_t* words = reinterpret_cast<uint32_t*>(met_s + A.NC);  // [32]
  int* chosen_s = reinterpret_cast<int*>(words + 32);

  const int r = blockIdx.x, c = r / A.Pn, p = r % A.Pn;
  const int tid = threadIdx.x, n = A.n;
  for (int k = tid; k < A.PR; k += kThreads)
    pr[k] = A.probs[size_t(c) * A.PR + k];
  for (int k = tid; k < meg::kCorrWords; k += kThreads) corr_s[k] = A.corr[k];
  __syncthreads();

  const int qc = clampi(A.q[size_t(c) * A.sq], 0, n - 1);
  int d[4];
  for (int s = 0; s < 4; ++s) d[s] = A.rec_dists[size_t(c) * A.sdists + s];
  const int32_t* slab = A.slab + size_t(c) * n;
  const meg::Packet cur = meg::unpack(uint32_t(slab[qc]));

  if (tid < kRankThreads) {
    // enumerate and rank: rank_plain's cost under the row's probabilities
    const int ctx = A.rec_ctx[size_t(c) * A.sctx], byte = A.data[qc];
    const int mb = A.data[clampi(qc - d[0] - 1, 0, n - 1)];
    const int prev = qc > 0 ? A.data[qc - 1] : 0;
    for (int k = tid; k < A.NC; k += kRankThreads) {
      const uint32_t w = candidate(A, k, qc, d, cur);
      const meg::Packet pk = meg::unpack(w);
      const bool valid = (w & meg::kLiveBit) != 0;
      const meg::PlanCtx pc = meg::plan_ctx(pk, ctx, byte, mb, prev, A.lc, L);
      int cost = meg::n_direct(pc) << meg::kProbBits;
      for (int j = 0; j < meg::kNSlots; ++j) {
        int row = 0, bit = 0;
        const bool act = valid && meg::plan_slot(pc, j, L, &row, &bit);
        const int ix = meg::cost_index(act ? pr[row] : meg::kProbOne / 2, bit);
        const int cj = meg::f32_log2_cost(ix) + meg::log2_corr(corr_s, ix);
        cost += act ? cj : 0;
      }
      const int m = valid ? cost / max(pk.len, 1) : kBig;
      cand_s[k] = w;
      met_s[k] = m;
      A.metric[size_t(r) * A.NC + k] = m;
    }
  } else {
    key_words(A, c, p, tid - kRankThreads, words);
  }
  __syncthreads();

  // biased top-K choice (moves.biased_topk_choice): count, the eight
  // draws and the forced-best escape give the ordinal `sel`; the chosen
  // candidate is the one with `sel` smaller keys under (metric, index)
  int nvalid = 0;
  for (int k = 0; k < A.NC; ++k) nvalid += cand_s[k] >> 31;
  const int count = min(nvalid, A.top_k);
  int choice = 0;
  for (int i = 0; i < kBiasDraws; ++i)
    choice = max(choice, tf::randint(words[kHigher + i], words[kLower + i],
                                     max(count, 1)));
  if (tf::uniform(words[kForced]) < 0.125f) choice = count - 1;
  const int sel = clampi(count - 1 - choice, 0, A.top_k - 1);
  if (tid < kRankThreads) {
    for (int k = tid; k < A.NC; k += kRankThreads) {
      const int mk = met_s[k];
      int ord = 0;
      for (int j = 0; j < A.NC; ++j) {
        const int mj = met_s[j];
        ord += mj < mk || (mj == mk && j < k);
      }
      if (ord == sel) *chosen_s = k;
    }
  }
  __syncthreads();
  if (tid != 0) return;

  // boundary moves (moves.select_mutation) and the two mutated cells
  const bool coin = tf::uniform(words[kCoin]) < 0.5f;
  const bool has_next = qc + 1 < n;
  const uint32_t cell0 = uint32_t(slab[qc]);
  const uint32_t cell1 = uint32_t(slab[min(qc + 1, n - 1)]);
  const meg::Packet nxt = meg::unpack(cell1);
  const bool first_is_match = cur.type == meg::kMatch || cur.type == meg::kLrep;
  const bool shrink_ok = has_next && first_is_match && cur.len > 2;
  const bool second_is_match = nxt.type == meg::kMatch || nxt.type == meg::kLrep;
  const int nd = min(nxt.dist, 3);
  const int sec_dist = nxt.type == meg::kLrep
      ? (nd == 0 ? d[0] : nd == 1 ? d[1] : nd == 2 ? d[2] : d[3]) : nxt.dist;
  const int rep_start = qc - sec_dist;
  const bool grow_ok = has_next &&
      (cur.type == meg::kLit || cur.type == meg::kSrep) && second_is_match &&
      nxt.len < kMatchLenMax && rep_start > 0 &&
      A.data[qc] == A.data[clampi(rep_start - 1, 0, n - 1)];
  const bool do_shrink = coin && shrink_ok;
  const bool do_grow = coin && !shrink_ok && grow_ok;
  const uint32_t picked = count > 0 ? cand_s[*chosen_s] & ~meg::kLiveBit
                                    : cell0;
  const uint32_t new_q = do_shrink ? pack_word(meg::kLit, 0, 1)
      : do_grow ? pack_word(nxt.type, nxt.dist, nxt.len + 1) : picked;
  const uint32_t new_q1 = do_shrink
      ? pack_word(cur.type, cur.dist, cur.len - 1) : cell1;
  A.v0[r] = int32_t(has_next ? new_q : new_q1);
  A.v1[r] = int32_t(new_q1);

  // the recording site and, once per chain, the acceptance draw and the
  // next key; block 0 advances the shared key
  const int span = A.site_mode == 1
      ? max(A.live_count[size_t(c) * A.slive], 1) : A.span;
  A.u[r] = A.u_lo + tf::randint(words[kSiteHi], words[kSiteLo], span);
  if (p == 0) {
    A.acc_u[c] = tf::uniform(words[kAcc]);
    A.key_next[2 * c] = words[kKeyNext];
    A.key_next[2 * c + 1] = words[kKeyNext + 1];
  }
  if (r == 0) {
    A.skey_next[0] = words[kSkeyNext];
    A.skey_next[1] = words[kSkeyNext + 1];
  }
}

}  // namespace

extern "C" int meg_propose(
    const int64_t* keys, const int64_t* skey, const int32_t* slab,
    const int32_t* q, const int32_t* rec_ctx, const int32_t* rec_dists,
    const int32_t* probs, const int32_t* live_count, const int32_t* data,
    const int32_t* rank, const int32_t* sparse, const int32_t* cand_dist,
    const int32_t* cand_len, const int32_t* cand_count, const int32_t* corr,
    int64_t* key_next, int64_t* skey_next, int32_t* v0, int32_t* v1,
    int32_t* u, float* acc_u, int32_t* metric, int Cn, int Pn, int n, int M,
    int SL, int top_k, int PR, int lc, int site_mode, int u_lo, int span,
    int sq, int sctx, int sdists, int slive, const int32_t* layout,
    cudaStream_t stream) {
  meg::Layout L;
  for (int k = 0; k < meg::kNumCls; ++k) L.row[k] = layout[k];
  for (int t = 0; t < 5; ++t)
    for (int k = 0; k < 11; ++k)
      L.rt_off[t][k] = layout[meg::kNumCls + t * 11 + k];
  const int NC = 2 + SL * (4 + M);
  if (Cn <= 0 || Pn <= 0 || n <= 0 || SL < 1 || SL > 10 || top_k < 1 ||
      top_k > NC)
    return int(cudaErrorInvalidValue);
  const Args A = {keys, skey, slab, q, rec_ctx, rec_dists, probs, live_count,
                  data, rank, sparse, cand_dist, cand_len, cand_count, corr,
                  key_next, skey_next, v0, v1, u, acc_u, metric,
                  Pn, n, M, NC, SL, top_k, PR, lc, site_mode, u_lo, span,
                  sq, sctx, sdists, slive};
  const size_t smem = sizeof(int) * (size_t(PR) + meg::kCorrWords +
                                     2 * size_t(NC) + 32 + 1);
  cudaError_t err = meg::allow_smem(propose_kernel, smem);
  if (err != cudaSuccess) return int(err);
  propose_kernel<<<Cn * Pn, kThreads, smem, stream>>>(A, L);
  return int(cudaGetLastError());
}
