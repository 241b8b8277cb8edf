"""Price-driven optimal-parse initializer (xz-class shortest path).

The reference can only seed annealing from the all-literals parse
(the reference's src/packet_slab.c:30-32); this seed is a near-optimal
parse: a rep-aware Viterbi DP over the dense candidate table with LZMA
price tables from trained probabilities — the approach of xz's optimum
encoder, re-derived for the candidate-table representation.  The DP runs
in the native engine (megalania_tpu/runtime/native/optparse.cpp, built
into the port's build directory); seeding at xz-class quality turns the
annealer into a strict refiner.

The port carries only the native path: megalania_tpu's numpy DP is a
fallback for hosts without a C++ toolchain, and a fallback would seed a
different parse (and so emit different bytes) without saying so.
"""
from __future__ import annotations

import numpy as np

from ..ops import tables as T
from . import candidates as C_


def build_optimal_slab_native(data, tab: C_.CandidateTable, lc: int = 0,
                              passes: int = 4, win_size: int = 8192,
                              index=None) -> np.ndarray:
    """xz-class optimum-parse seed via the native Viterbi engine.

    Each pass parses with STATIC price tables snapshotted every
    win_size bytes from the previous parse's exact adaptive model
    (window w's prices = the model state entering position w*win_size),
    so prices track the coder's actual evolution through the block.
    The Viterbi nodes carry the exact ctx_state and the best arrival's
    rep stack, and every candidate length 2..273 is relaxed (the
    reference's semantics, substring_enumerator.c:85-105).  The parse
    with the cheapest EXACT adaptive cost across passes wins.
    """
    from . import optparse_native as on
    from ..models import packets as P

    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    if n == 0:
        return np.asarray(P.literal_slab(0))
    if index is None:
        from .suffix import build_lce
        index = build_lce(data)
    # win_size=0: sweep the snapshot windows and keep the exact-cost best
    # (the best window varies per input)
    wins = ((256, 512, 1024) if win_size == 0
            else (win_size,))
    wins = sorted({max(256, min(w, max(n, 1))) for w in wins})

    def parse(pw, ws):
        return on.viterbi_parse(data, pw, tab.dist, tab.length,
                                index.rank, index.sparse, lc=lc,
                                win_size=ws)

    fresh = T.init_probs_np(lc=lc)[None, :]
    first = parse(fresh, 0)
    best, best_cost = first, None
    for win in wins:
        nwin = -(-n // win)
        slab = first
        for _ in range(max(0, passes - 1)):
            cost, _, snaps = on.cost_train(data, slab, lc=lc, nwin=nwin,
                                           win_size=win)
            if best_cost is None or cost < best_cost:
                best, best_cost = slab, cost
            slab = parse(snaps, win)
        cost, _ = on.cost_train(data, slab, lc=lc)
        if best_cost is None or cost < best_cost:
            best, best_cost = slab, cost
    return best


def seed_slab(data, cfg, index=None):
    """Config-driven optimum-parse seed — the single function behind
    both engine.make_context and the compressor's DP-only mode, so their
    seeds can never drift.

    Returns (slab, None) (None: no wide-distance array; wide blocks are
    not carried by the port).  The native library is built from
    megalania_tpu/runtime/native/optparse.cpp on first use; a failed
    build raises."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    if index is None:
        from .suffix import build_lce
        index = build_lce(data)
    tab = C_.build_candidates(data, cfg.opt_candidates, cfg.opt_walk,
                              index)
    return build_optimal_slab_native(
        data, tab, lc=cfg.lc, passes=cfg.opt_passes,
        win_size=cfg.opt_window, index=index), None
