// Native optimum-parse engine: rep-aware exact-ctx-state Viterbi DP +
// an exact adaptive cost/train pass.
//
// This is the host-side seed generator for the TPU annealer.  The
// reference has nothing like it (it can only seed from all-literals,
// Megalania src/packet_slab.c:30-32); quality bar is xz's optimum
// encoder: per-node state = (exact LZMA ctx_state 0..11, 4-deep rep
// stack of the best arrival), single-best-arrival relaxation over
// every candidate length (dense 2..273, the reference enumerator's
// semantics, Megalania src/substring_enumerator.c:85-105), rep
// matches discovered per node via O(1) suffix-array LCE queries, and
// price tables refreshed every `win_size` bytes from adaptive-model
// snapshots of the previous pass (the "settle at window edges" rule).
//
// Prices and the exact cost pass share the flat probability layout of
// megalania_tpu/ops/tables.py; the offsets array keeps this file free
// of layout constants.  Cost semantics mirror runtime/pyemit.py (the
// spec oracle; parity is asserted by tests/test_optparse.py).
//
// Build: make -C megalania_tpu/runtime/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kProbBits = 11;
constexpr int32_t kProbOne = 1 << kProbBits;     // 2048
constexpr int32_t kMoveBits = 5;
constexpr int64_t kInf = int64_t(1) << 62;
constexpr int kNumStates = 12;
constexpr int kMatchLenMin = 2;

// packed-packet layout (models/packets.py)
constexpr uint32_t kDistMask = (1u << 20) - 1;
constexpr int kLenShift = 20;
constexpr int kTypeShift = 29;
constexpr uint32_t kLit = 0, kMatch = 1, kSrep = 2, kLrep = 3;

// offsets array indices (filled by match/optparse_native.py from
// ops/tables.py — single source of truth for the layout)
enum {
  O_IS_MATCH = 0, O_IS_REP, O_IS_REP_G0, O_IS_REP_G1, O_IS_REP_G2,
  O_IS_REP0_LONG, O_LEN, O_REP_LEN, O_DIST_SLOT, O_ALIGN, O_POS_CODER,
  O_LIT, O_POS_BITS_MAX, O_MATCH_LEN_MAX,
  O_LEN_CHOICE1, O_LEN_CHOICE2, O_LEN_LOW, O_LEN_MID, O_LEN_HIGH,
  O_COUNT
};

struct Layout {
  const int32_t* o;
  int pbm() const { return o[O_POS_BITS_MAX]; }
};

// ctx-state transitions (semantics of Megalania src/lzma_state.c:
// 29-57, identical to ops/tables.py make_ctx_transition)
inline int next_ctx(int type, int s) {
  switch (type) {
    case 0:  return s < 4 ? 0 : (s < 10 ? s - 3 : s - 6);  // literal
    case 1:  return s < 7 ? 7 : 10;                        // match
    case 2:  return s < 7 ? 9 : 11;                        // short rep
    default: return s < 7 ? 8 : 11;                        // long rep
  }
}

inline int64_t bit_cost(const int64_t* log2tab, int32_t p, int bit) {
  return log2tab[bit ? kProbOne - p : p];
}

// ---------------------------------------------------------------------
// price helpers over a STATIC probability snapshot
// ---------------------------------------------------------------------

static void tree_prices(const int32_t* probs, const int64_t* log2tab,
                        int base, int nbits, int nvals, int64_t* out) {
  for (int v = 0; v < nvals; ++v) {
    int64_t c = 0;
    int m = 1;
    for (int j = nbits - 1; j >= 0; --j) {
      int bit = (v >> j) & 1;
      c += bit_cost(log2tab, probs[base + m], bit);
      m = (m << 1) | bit;
    }
    out[v] = c;
  }
}

static int64_t rev_price(const int32_t* probs, const int64_t* log2tab,
                         int base, int nbits, uint32_t value) {
  int64_t c = 0;
  int m = 1;
  for (int j = 0; j < nbits; ++j) {
    int bit = value & 1;
    value >>= 1;
    c += bit_cost(log2tab, probs[base + m], bit);
    m = (m << 1) | bit;
  }
  return c;
}

// per-window price tables (one per win_size bytes of input)
struct WinPrices {
  int64_t lenp[272];       // match length price, len2 = len - 2
  int64_t replenp[272];    // rep length price
  int64_t slotp[4][64];    // dist slot price per len-ctx
  int64_t alignp[16];
  int64_t lit0[kNumStates];       // is_match=0 header per ctx
  int64_t mhdr[kNumStates];       // is_match=1,is_rep=0 header
  int64_t rhdr[kNumStates][4];    // long-rep header per rep index
  int64_t srep[kNumStates];       // full short-rep price
};

static void len_prices(const int32_t* probs, const int64_t* log2tab,
                       int base, const Layout& L, int64_t* out) {
  int64_t low[8], mid[8], high[256];
  tree_prices(probs, log2tab, base + L.o[O_LEN_LOW], 3, 8, low);
  tree_prices(probs, log2tab, base + L.o[O_LEN_MID], 3, 8, mid);
  tree_prices(probs, log2tab, base + L.o[O_LEN_HIGH], 8, 256, high);
  int64_t c1_0 = bit_cost(log2tab, probs[base + L.o[O_LEN_CHOICE1]], 0);
  int64_t c1_1 = bit_cost(log2tab, probs[base + L.o[O_LEN_CHOICE1]], 1);
  int64_t c2_0 = bit_cost(log2tab, probs[base + L.o[O_LEN_CHOICE2]], 0);
  int64_t c2_1 = bit_cost(log2tab, probs[base + L.o[O_LEN_CHOICE2]], 1);
  for (int v = 0; v < 8; ++v) out[v] = c1_0 + low[v];
  for (int v = 8; v < 16; ++v) out[v] = c1_1 + c2_0 + mid[v - 8];
  for (int v = 16; v < 272; ++v) out[v] = c1_1 + c2_1 + high[v - 16];
}

static void build_win_prices(const int32_t* probs, const int64_t* log2tab,
                             const Layout& L, WinPrices* w) {
  len_prices(probs, log2tab, L.o[O_LEN], L, w->lenp);
  len_prices(probs, log2tab, L.o[O_REP_LEN], L, w->replenp);
  for (int c = 0; c < 4; ++c)
    tree_prices(probs, log2tab, L.o[O_DIST_SLOT] + 64 * c, 6, 64,
                w->slotp[c]);
  tree_prices(probs, log2tab, L.o[O_ALIGN], 4, 16, w->alignp);
  for (int s = 0; s < kNumStates; ++s) {
    int ism = L.o[O_IS_MATCH] + (s << L.pbm());
    int64_t m0 = bit_cost(log2tab, probs[ism], 0);
    int64_t m1 = bit_cost(log2tab, probs[ism], 1);
    int64_t rep0 = bit_cost(log2tab, probs[L.o[O_IS_REP] + s], 0);
    int64_t rep1 = bit_cost(log2tab, probs[L.o[O_IS_REP] + s], 1);
    int64_t g0_0 = bit_cost(log2tab, probs[L.o[O_IS_REP_G0] + s], 0);
    int64_t g0_1 = bit_cost(log2tab, probs[L.o[O_IS_REP_G0] + s], 1);
    int64_t g1_0 = bit_cost(log2tab, probs[L.o[O_IS_REP_G1] + s], 0);
    int64_t g1_1 = bit_cost(log2tab, probs[L.o[O_IS_REP_G1] + s], 1);
    int64_t g2_0 = bit_cost(log2tab, probs[L.o[O_IS_REP_G2] + s], 0);
    int64_t g2_1 = bit_cost(log2tab, probs[L.o[O_IS_REP_G2] + s], 1);
    int r0l = L.o[O_IS_REP0_LONG] + (s << L.pbm());
    int64_t r0l_0 = bit_cost(log2tab, probs[r0l], 0);
    int64_t r0l_1 = bit_cost(log2tab, probs[r0l], 1);
    w->lit0[s] = m0;
    w->mhdr[s] = m1 + rep0;
    w->rhdr[s][0] = m1 + rep1 + g0_0 + r0l_1;
    w->rhdr[s][1] = m1 + rep1 + g0_1 + g1_0;
    w->rhdr[s][2] = m1 + rep1 + g0_1 + g1_1 + g2_0;
    w->rhdr[s][3] = m1 + rep1 + g0_1 + g1_1 + g2_1;
    w->srep[s] = m1 + rep1 + g0_0 + r0l_0;
  }
}

// literal price (normal or matched mode) against a static snapshot
static int64_t lit_price(const int32_t* probs, const int64_t* log2tab,
                         const Layout& L, int lc, int byte, int prev,
                         int match_byte, bool matched) {
  int base = L.o[O_LIT] + (lc ? (prev >> (8 - lc)) * 0x300 : 0);
  int64_t c = 0;
  int symbol = 1;
  for (int i = 7; i >= 0; --i) {
    int bit = (byte >> i) & 1;
    int slot = base + symbol;
    if (matched) {
      int mbit = (match_byte >> i) & 1;
      slot += (1 + mbit) << 8;
      matched = mbit == bit;
    }
    c += bit_cost(log2tab, probs[slot], bit);
    symbol = (symbol << 1) | bit;
  }
  return c;
}

// stored-form distance -> (pos slot, static tail price)
static inline int dist_slot(uint32_t d) {
  if (d < 4) return int(d);
  int nlb = 30 - __builtin_clz(d | 1);  // bit_length - 2
  int high = int(d >> nlb);
  return nlb * 2 + high;
}

static int64_t dist_tail_price(const int32_t* probs, const int64_t* log2tab,
                               const Layout& L, const WinPrices& w,
                               uint32_t d, int ps) {
  if (ps < 4) return 0;
  if (ps < 14) {
    int nlb = (ps >> 1) - 1;
    uint32_t high = d >> nlb;
    uint32_t low = d & ((1u << nlb) - 1);
    int base = L.o[O_POS_CODER] + int(high << nlb) - ps;
    return rev_price(probs, log2tab, base, nlb, low);
  }
  int nlb = 30 - __builtin_clz(d | 1);
  return (int64_t(nlb - 4) << kProbBits) + w.alignp[d & 15];
}

// O(1) LCE via the precomputed SA rank + sparse-table-min over LCP
// (match/suffix.py semantics; replaces the reference's byte-by-byte
// extension walk, substring_enumerator.c:92-101)
struct Lce {
  const int32_t* rank;
  const int32_t* sparse;  // [K][n]
  int64_t n;
  int32_t K;
  int32_t operator()(int64_t a, int64_t b) const {
    if (a == b) return int32_t(n - a);
    int32_t ra = rank[a], rb = rank[b];
    int32_t lo = (ra < rb ? ra : rb) + 1;
    int32_t hi = (ra < rb ? rb : ra) + 1;
    int32_t span = hi - lo;
    if (span < 1) span = 1;
    int k = 31 - __builtin_clz(uint32_t(span));
    int32_t left = sparse[int64_t(k) * n + lo];
    int32_t right = sparse[int64_t(k) * n + hi - (1 << k)];
    return left < right ? left : right;
  }
};

}  // namespace

extern "C" {

// Exact adaptive cost of a packed parse, training `probs` in place and
// (optionally) snapshotting the model at every win_size boundary.
// Returns the total perplexity in 53.11 fixed point, or -1 on a
// malformed slab.  Mirrors runtime/pyemit.py Encoder bit for bit.
// dist_wide (nullable): full 32-bit stored-form MATCH distances, one
// per packet start position — overrides the packed 20-bit dist field
// so blocks larger than 1 MiB (the packed format's cap,
// models/packets.py) can be costed/parsed host-side.
int64_t meg_cost_train(const uint8_t* data, int64_t n,
                       const uint32_t* slab, const uint32_t* dist_wide,
                       int32_t lc, int32_t* probs,
                       int32_t* snaps, int64_t nwin, int64_t win_size,
                       int64_t probs_stride, const int64_t* log2tab,
                       const int32_t* offsets, int64_t n_offsets) {
  if (n_offsets < O_COUNT) return -1;
  Layout L{offsets};
  int64_t perp = 0;
  int ctx = 0;
  uint32_t dists[4] = {0, 0, 0, 0};
  int64_t snap_next = (snaps && nwin > 0) ? 0 : kInf;
  int64_t wi = 0;

  auto abit = [&](int bit, int slot) {
    int32_t p = probs[slot];
    perp += bit_cost(log2tab, p, bit);
    probs[slot] = bit ? p - (p >> kMoveBits)
                      : p + ((kProbOne - p) >> kMoveBits);
  };
  auto tree = [&](uint32_t value, int nbits, int base) {
    int m = 1;
    for (int i = nbits - 1; i >= 0; --i) {
      int bit = (value >> i) & 1;
      abit(bit, base + m);
      m = (m << 1) | bit;
    }
  };
  auto tree_rev = [&](uint32_t value, int nbits, int base) {
    int m = 1;
    for (int i = 0; i < nbits; ++i) {
      int bit = value & 1;
      value >>= 1;
      abit(bit, base + m);
      m = (m << 1) | bit;
    }
  };
  auto length_coder = [&](int base, int len) {
    int len2 = len - kMatchLenMin;
    if (len2 < 8) {
      abit(0, base + L.o[O_LEN_CHOICE1]);
      tree(len2, 3, base + L.o[O_LEN_LOW]);
    } else if (len2 < 16) {
      abit(1, base + L.o[O_LEN_CHOICE1]);
      abit(0, base + L.o[O_LEN_CHOICE2]);
      tree(len2 - 8, 3, base + L.o[O_LEN_MID]);
    } else {
      abit(1, base + L.o[O_LEN_CHOICE1]);
      abit(1, base + L.o[O_LEN_CHOICE2]);
      tree(len2 - 16, 8, base + L.o[O_LEN_HIGH]);
    }
  };

  int64_t pos = 0;
  while (pos < n) {
    while (pos >= snap_next && wi < nwin) {
      std::memcpy(snaps + wi * probs_stride, probs,
                  size_t(probs_stride) * sizeof(int32_t));
      ++wi;
      snap_next = wi * win_size;
    }
    uint32_t word = slab[pos];
    uint32_t type = (word >> kTypeShift) & 3;
    uint32_t d = word & kDistMask;
    if (dist_wide && type == kMatch) d = dist_wide[pos];
    int len = int((word >> kLenShift) & 0x1FF);
    if (len < 1 || pos + len > n) return -1;
    int ism = L.o[O_IS_MATCH] + (ctx << L.pbm());
    if (type == kLit) {
      abit(0, ism);
      int byte = data[pos];
      bool matched = ctx >= 7;
      int match_byte =
          matched ? data[pos - int64_t(dists[0]) - 1] : 0;
      int prev = pos > 0 ? data[pos - 1] : 0;
      int base = L.o[O_LIT] + (lc ? (prev >> (8 - lc)) * 0x300 : 0);
      int symbol = 1;
      for (int i = 7; i >= 0; --i) {
        int bit = (byte >> i) & 1;
        int slot = base + symbol;
        if (matched) {
          int mbit = (match_byte >> i) & 1;
          slot += (1 + mbit) << 8;
          matched = mbit == bit;
        }
        abit(bit, slot);
        symbol = (symbol << 1) | bit;
      }
    } else if (type == kMatch) {
      abit(1, ism);
      abit(0, L.o[O_IS_REP] + ctx);
      dists[3] = dists[2]; dists[2] = dists[1]; dists[1] = dists[0];
      dists[0] = d;
      length_coder(L.o[O_LEN], len);
      int len_ctx = len - kMatchLenMin < 3 ? len - kMatchLenMin : 3;
      int ps = dist_slot(d);
      tree(ps, 6, L.o[O_DIST_SLOT] + 64 * len_ctx);
      if (ps >= 4) {
        int nlb = ps < 14 ? (ps >> 1) - 1 : 30 - __builtin_clz(d | 1);
        uint32_t low = d & ((1u << nlb) - 1);
        uint32_t high = d >> nlb;
        if (ps < 14) {
          tree_rev(low, nlb, L.o[O_POS_CODER] + int(high << nlb) - ps);
        } else {
          perp += int64_t(nlb - 4) << kProbBits;  // direct bits
          tree_rev(d & 15, 4, L.o[O_ALIGN]);
        }
      }
    } else if (type == kSrep) {
      abit(1, ism);
      abit(1, L.o[O_IS_REP] + ctx);
      abit(0, L.o[O_IS_REP_G0] + ctx);
      abit(0, L.o[O_IS_REP0_LONG] + (ctx << L.pbm()));
    } else {  // long rep, d = rep index
      if (d > 3) return -1;
      abit(1, ism);
      abit(1, L.o[O_IS_REP] + ctx);
      abit(d != 0, L.o[O_IS_REP_G0] + ctx);
      if (d != 0) {
        abit(d != 1, L.o[O_IS_REP_G1] + ctx);
        if (d != 1) abit(d != 2, L.o[O_IS_REP_G2] + ctx);
      } else {
        abit(1, L.o[O_IS_REP0_LONG] + (ctx << L.pbm()));
      }
      uint32_t dv = dists[d];
      for (uint32_t k = d; k > 0; --k) dists[k] = dists[k - 1];
      dists[0] = dv;
      length_coder(L.o[O_REP_LEN], len);
    }
    ctx = next_ctx(int(type), ctx);
    pos += len;
  }
  while (wi < nwin) {  // tail windows see the final model
    std::memcpy(snaps + wi * probs_stride, probs,
                size_t(probs_stride) * sizeof(int32_t));
    ++wi;
  }
  return perp;
}

// Rep-aware Viterbi optimum parse over windowed price snapshots.
// probs_win: [nwin][probs_stride] static model snapshots; edges leaving
// position i are priced with window i / win_size.  Writes the packed
// parse into slab_out and returns the DP's own cost estimate (static
// prices — the caller re-costs exactly with meg_cost_train).
int64_t meg_optparse_viterbi(
    const uint8_t* data, int64_t n, const int32_t* probs_win,
    int64_t nwin, int64_t win_size, int64_t probs_stride, int32_t lc,
    const int32_t* cand_dist, const int32_t* cand_len, int32_t M,
    const int32_t* rank, const int32_t* sparse, int32_t K,
    const int64_t* log2tab, const int32_t* offsets, int64_t n_offsets,
    uint32_t* slab_out, uint32_t* dist_wide_out) {
  if (n_offsets < O_COUNT || n <= 0 || nwin <= 0) return -1;
  Layout L{offsets};
  const int max_len_total = offsets[O_MATCH_LEN_MAX];
  Lce lce{rank, sparse, n, K};

  std::vector<WinPrices> wins(static_cast<size_t>(nwin));
  for (int64_t w = 0; w < nwin; ++w)
    build_win_prices(probs_win + w * probs_stride, log2tab, L, &wins[w]);

  std::vector<int64_t> cost(size_t(n) + 1, kInf);
  std::vector<int8_t> ctx(size_t(n) + 1, 0);
  std::vector<uint32_t> reps(4 * (size_t(n) + 1), 0);
  // backpointers: packet that produced each node's best arrival
  std::vector<int8_t> bp_type(size_t(n) + 1, 0);
  std::vector<uint32_t> bp_d(size_t(n) + 1, 0);
  std::vector<int32_t> bp_len(size_t(n) + 1, 0);
  cost[0] = 0;

  for (int64_t i = 0; i < n; ++i) {
    const int64_t ci = cost[i];
    if (ci >= kInf) continue;  // unreachable (cannot happen: literals)
    const int s = ctx[i];
    const uint32_t* R = &reps[4 * size_t(i)];
    const int64_t w = i / win_size < nwin ? i / win_size : nwin - 1;
    const WinPrices& W = wins[size_t(w)];
    const int32_t* probs = probs_win + w * probs_stride;
    const int max_len =
        n - i < max_len_total ? int(n - i) : max_len_total;

    auto relax = [&](int64_t tgt, int64_t c, int type, uint32_t d,
                     int len) {
      if (c < cost[tgt]) {
        cost[tgt] = c;
        ctx[tgt] = int8_t(next_ctx(type, s));
        uint32_t* RT = &reps[4 * size_t(tgt)];
        if (type == int(kMatch)) {
          RT[0] = d; RT[1] = R[0]; RT[2] = R[1]; RT[3] = R[2];
        } else if (type == int(kLrep)) {
          uint32_t dv = R[d];
          RT[0] = dv;
          for (uint32_t k2 = 0, j = 0; j < 4; ++j)
            if (j != d) RT[++k2] = R[j];
        } else {
          RT[0] = R[0]; RT[1] = R[1]; RT[2] = R[2]; RT[3] = R[3];
        }
        bp_type[tgt] = int8_t(type);
        bp_d[tgt] = d;
        bp_len[tgt] = len;
      }
    };

    // literal -> i+1
    {
      bool matched = s >= 7;
      int64_t src = i - int64_t(R[0]) - 1;
      int mb = (matched && src >= 0) ? data[src] : 0;
      int prev = i > 0 ? data[i - 1] : 0;
      int64_t c = ci + W.lit0[s] +
                  lit_price(probs, log2tab, L, lc, data[i], prev, mb,
                            matched && src >= 0);
      relax(i + 1, c, kLit, 0, 1);
    }
    // short rep -> i+1
    {
      int64_t src = i - int64_t(R[0]) - 1;
      if (src >= 0 && data[src] == data[i])
        relax(i + 1, ci + W.srep[s], kSrep, 0, 1);
    }
    // long reps: dense lengths 2..ext per distinct live rep slot
    for (int r = 0; r < 4; ++r) {
      uint32_t dr = R[r];
      bool dup = false;
      for (int q = 0; q < r; ++q) dup |= (R[q] == dr);
      if (dup) continue;  // promoted duplicates price worse at q > r
      int64_t src = i - int64_t(dr) - 1;
      if (src < 0) continue;
      int ext = lce(i, src);
      if (ext > max_len) ext = max_len;
      if (ext < kMatchLenMin) continue;
      int64_t base = ci + W.rhdr[s][r];
      for (int l = kMatchLenMin; l <= ext; ++l)
        relax(i + l, base + W.replenp[l - kMatchLenMin], kLrep,
              uint32_t(r), l);
    }
    // table matches: dense lengths, nearest candidate per length
    // (the table is Pareto nearest-first: length strictly grows with
    // the slot index, so slot m covers lengths (len[m-1], len[m]])
    {
      int64_t mbase = ci + W.mhdr[s];
      int prev_cap = kMatchLenMin - 1;
      for (int m = 0; m < M && prev_cap < max_len; ++m) {
        int cl = cand_len[i * M + m];
        if (cl <= 0) break;
        uint32_t d = uint32_t(cand_dist[i * M + m]);
        int cap = cl < max_len ? cl : max_len;
        if (cap <= prev_cap) continue;
        int ps = dist_slot(d);
        int64_t tail = dist_tail_price(probs, log2tab, L, W, d, ps);
        int64_t dp4[4];
        for (int c4 = 0; c4 < 4; ++c4)
          dp4[c4] = W.slotp[c4][ps] + tail;
        for (int l = prev_cap + 1; l <= cap; ++l) {
          int lc2 = l - kMatchLenMin < 3 ? l - kMatchLenMin : 3;
          relax(i + l, mbase + W.lenp[l - kMatchLenMin] + dp4[lc2],
                kMatch, d, l);
        }
        prev_cap = cap;
      }
    }
  }

  // backtrack: every node's state/backptr was written by the winning
  // arrival, so the reverse walk reconstructs a consistent parse
  for (int64_t i = 0; i < n; ++i) {
    slab_out[i] = (1u << kLenShift);  // literal, len 1
    if (dist_wide_out) dist_wide_out[i] = 0;
  }
  int64_t pos = n;
  while (pos > 0) {
    int len = bp_len[pos];
    int type = bp_type[pos];
    uint32_t d = bp_d[pos];
    int64_t at = pos - len;
    slab_out[at] = (d & kDistMask) | (uint32_t(len) << kLenShift) |
                   (uint32_t(type) << kTypeShift);
    if (dist_wide_out) dist_wide_out[at] = d;
    pos = at;
  }
  return cost[size_t(n)];
}

// Kasai's LCP construction (match/suffix.py lcp_array semantics) —
// the Python loop is the index-build bottleneck past ~1 MiB.
void meg_lcp(const uint8_t* data, int64_t n, const int32_t* sa,
             int32_t* lcp_out) {
  std::vector<int64_t> rank(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) rank[size_t(sa[i])] = i;
  int64_t h = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = rank[size_t(i)];
    lcp_out[r] = 0;
    if (r > 0) {
      int64_t j = sa[r - 1];
      while (i + h < n && j + h < n && data[i + h] == data[j + h]) ++h;
      lcp_out[r] = int32_t(h);
      if (h) --h;
    } else {
      h = 0;
    }
  }
}

}  // extern "C"
