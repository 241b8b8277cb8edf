"""Probability-model layout and fixed-point log2 cost table.

The LZMA adaptive probability model is held as ONE flat int32 vector per
chain so that the annealing scan can gather/scatter probability slots with
a single vectorized op.  Layout mirrors the semantic groups of the LZMA
format (the reference's src/lzma_state.h:15-55) but flattened
with static offsets; values are 11-bit probabilities (0..2048).

Cost model: fixed point "bits << 11".  LOG2_LOOKUP[i] = trunc(-log2(i/2048)
* 2048), LOG2_LOOKUP[0] = 0 sentinel (reference: generate_table.py:7-9,
perplexity_encoder.c:6-17).  The table is *computed* here, not copied.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Fixed-point parameters (LZMA spec constants)
# ---------------------------------------------------------------------------
PROB_BITS = 11                 # probabilities are 11-bit: p(bit==0) = P/2048
PROB_ONE = 1 << PROB_BITS      # 2048
PROB_INIT = PROB_ONE // 2      # 1024
MOVE_BITS = 5                  # adaptation shift

NUM_STATES = 12                # ctx-state machine size
# pb=0 (the reference hardcodes it too, main.c:45) => pos_state is always 0,
# so no position-context lanes are reserved: IS_MATCH/IS_REP0_LONG compact to
# one slot per ctx-state.  A pb>0 extension would raise this to `pb`.
POS_BITS_MAX = 0

MATCH_LEN_MIN = 2
MATCH_LEN_MAX = 273

# ---------------------------------------------------------------------------
# Flat probability-table layout (sizes per group)
# ---------------------------------------------------------------------------
IS_MATCH = 0                                   # [12 << 4] ctx_state<<4 | posbits
IS_REP = IS_MATCH + (NUM_STATES << POS_BITS_MAX)          # [12]
IS_REP_G0 = IS_REP + NUM_STATES                           # [12]
IS_REP_G1 = IS_REP_G0 + NUM_STATES                        # [12]
IS_REP_G2 = IS_REP_G1 + NUM_STATES                        # [12]
IS_REP0_LONG = IS_REP_G2 + NUM_STATES                     # [12 << 4]

# Length coder: choice1, choice2, low[8], mid[8], high[256].  pb=0 means a
# single position context, so the 16 pos-context copies of the low/mid trees
# in the generic LZMA layout collapse to one (the reference reserves them but
# also only ever uses pos ctx 0, src/lzma_packet_encoder.c:44 todo).
LEN_CHOICE1 = 0
LEN_CHOICE2 = 1
LEN_LOW = 2                    # 8 tree slots (nodes 1..7 used)
LEN_MID = LEN_LOW + 8          # 10
LEN_HIGH = LEN_MID + 8         # 18
LEN_CODER_SIZE = LEN_HIGH + 256 + 6  # 280: +6 pad keeps groups 8-aligned

LEN = IS_REP0_LONG + (NUM_STATES << POS_BITS_MAX)         # match lengths
REP_LEN = LEN + LEN_CODER_SIZE                            # rep lengths

# Distance coder: pos_slot[4][64], align[16], pos_coder[115]
DIST_SLOT = REP_LEN + LEN_CODER_SIZE
ALIGN = DIST_SLOT + 4 * 64
POS_CODER = ALIGN + 16         # 1 + 128 - 14 = 115 slots

LIT = POS_CODER + 120          # literal coder, 0x300 slots (lc=lp=0);
#                                115 pos_coder slots + 5 alignment pad

NUM_PROBS = LIT + 0x300        # 1792: the reference's 2615-prob model minus
#                                the pos-context and pos-state copies that
#                                pb=0 leaves permanently unused
PROBS_PAD = 1920               # pad: multiple of 128 lanes / 8 sublanes,
#                                with head-room for DEAD_SLOT
DEAD_SLOT = PROBS_PAD - 1      # scatter target for masked-out bit ops


# ---------------------------------------------------------------------------
# lc > 0 layouts.  The literal coder is the LAST group of the flat
# layout, so literal-context support (lc bits of the previous byte select
# one of 2^lc literal prob sub-tables, LZMA spec; the reference hardcodes
# lc=0 with a todo, lzma_packet_encoder.c:113) only GROWS the tail: every
# group offset above stays valid for any lc.  lp/pb stay 0.
# ---------------------------------------------------------------------------

def lit_size(lc: int = 0) -> int:
    return 0x300 << lc


def num_probs(lc: int = 0) -> int:
    return LIT + lit_size(lc)


def probs_pad(lc: int = 0) -> int:
    return -(-(num_probs(lc) + 1) // 128) * 128   # room for DEAD_SLOT


def dead_slot(lc: int = 0) -> int:
    return probs_pad(lc) - 1


assert NUM_PROBS == 1792
assert num_probs(0) == NUM_PROBS and probs_pad(0) == PROBS_PAD
assert LIT % 8 == 0 and LEN % 8 == 0 and REP_LEN % 8 == 0
assert DIST_SLOT % 8 == 0 and ALIGN % 8 == 0 and POS_CODER % 8 == 0
assert DEAD_SLOT >= NUM_PROBS

# ---------------------------------------------------------------------------
# log2 cost table
# ---------------------------------------------------------------------------


def make_log2_table() -> np.ndarray:
    """-log2(i/2048)*2048, truncated toward zero; index 0 is a sentinel 0."""
    i = np.arange(1, PROB_ONE, dtype=np.float64)
    vals = np.trunc(-np.log2(i / PROB_ONE) * PROB_ONE)
    out = np.zeros(PROB_ONE, dtype=np.int64)
    out[1:] = vals.astype(np.int64)
    return out


LOG2_TABLE_NP = make_log2_table()          # int64 numpy master copy
LOG2_TABLE_I32 = LOG2_TABLE_NP.astype(np.int32)  # max value 11*2048 fits easily


def init_probs_np(batch_shape: tuple = (), lc: int = 0) -> np.ndarray:
    """Fresh probability vector(s): every real slot = PROB_INIT, padding = 0."""
    probs = np.zeros(batch_shape + (probs_pad(lc),), dtype=np.int32)
    probs[..., :num_probs(lc)] = PROB_INIT
    return probs


# ctx-state transition table T[type, state] (semantics of
# the reference's src/lzma_state.c:29-57, re-derived from the LZMA spec:
# literal cools the state toward 0, match/rep jump to their post-states).
# Internal packet type codes: LIT=0, MATCH=1, SREP=2, LREP=3.
def make_ctx_transition() -> np.ndarray:
    t = np.zeros((4, NUM_STATES), dtype=np.int32)
    s = np.arange(NUM_STATES)
    t[0] = np.where(s < 4, 0, np.where(s < 10, s - 3, s - 6))   # literal
    t[1] = np.where(s < 7, 7, 10)                               # match
    t[2] = np.where(s < 7, 9, 11)                               # short rep
    t[3] = np.where(s < 7, 8, 11)                               # long rep
    return t


CTX_TRANSITION_NP = make_ctx_transition()
