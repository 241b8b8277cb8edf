"""Price-driven optimal-parse initializer (xz-class shortest path).

The reference can only seed annealing from the all-literals parse
(the reference's src/packet_slab.c:30-32); this seed is a near-optimal
parse: a rep-aware Viterbi DP over the dense candidate table with LZMA
price tables from trained probabilities — the approach of xz's optimum
encoder, re-derived for the candidate-table representation.  The DP runs
in the native engine (megalania_tpu_torch/native/optparse.cpp, built
into the port's build directory); seeding at xz-class quality turns the
annealer into a strict refiner.

The port carries only the native path: megalania_tpu's numpy DP is a
fallback for hosts without a C++ toolchain, and a fallback would seed a
different parse (and so emit different bytes) without saying so.
"""
from __future__ import annotations

import numpy as np

from ..models import packets as P
from ..ops import tables as T
from ..utils.profiling import span
from . import candidates as C_
from .suffix import build_lce


def build_optimal_slab_native(data, tab: C_.CandidateTable, lc: int = 0,
                              passes: int = 4, win_size: int = 8192,
                              index=None, wide: bool = False):
    """xz-class optimum-parse seed via the native Viterbi engine.

    Each pass parses with STATIC price tables snapshotted every
    win_size bytes from the previous parse's exact adaptive model
    (window w's prices = the model state entering position w*win_size),
    so prices track the coder's actual evolution through the block.
    The Viterbi nodes carry the exact ctx_state and the best arrival's
    rep stack, and every candidate length 2..273 is relaxed (the
    reference's semantics, substring_enumerator.c:85-105).  The parse
    with the cheapest EXACT adaptive cost across passes wins.

    Returns (slab, dists): with wide=True dists is the full-width
    distance array (blocks over 1 MiB), otherwise None.
    """
    from . import optparse_native as on

    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    if n == 0:
        return (np.asarray(P.literal_slab(0)),
                np.zeros(0, np.uint32) if wide else None)
    if index is None:
        index = build_lce(data)
    # win_size=0: sweep the snapshot windows and keep the exact-cost best
    # (the best window varies per input)
    wins = ((256, 512, 1024) if win_size == 0
            else (win_size,))
    wins = sorted({max(256, min(w, max(n, 1))) for w in wins})

    def parse(pw, ws):
        return on.viterbi_parse(data, pw, tab.dist, tab.length,
                                index.rank, index.sparse, lc=lc,
                                win_size=ws, wide=wide)

    fresh = T.init_probs_np(lc=lc)[None, :]
    first = parse(fresh, 0)
    best, best_cost = first, None
    for win in wins:
        nwin = -(-n // win)
        slab, dw = first
        for _ in range(max(0, passes - 1)):
            cost, _, snaps = on.cost_train(data, slab, lc=lc, nwin=nwin,
                                           win_size=win, dists=dw)
            if best_cost is None or cost < best_cost:
                best, best_cost = (slab, dw), cost
            slab, dw = parse(snaps, win)
        cost, _ = on.cost_train(data, slab, lc=lc, dists=dw)
        if best_cost is None or cost < best_cost:
            best, best_cost = (slab, dw), cost
    return best


def seed_slab(data, cfg, device="cpu", index: C_.BlockIndex | None = None,
              table: C_.CandidateTable | None = None):
    """The block's initial parse under cfg.init: the one function that
    decides it, for engine.make_context and the compressor's DP-only
    mode alike, so their seeds can never drift.

    - literal: the all-literal parse;
    - greedy, mixed: the greedy walk (candidates.greedy_slab) over the
      annealer's table (max_candidates x max_walk);
    - optimal, mixed_opt, and every wide (> 1 MiB) block whatever its
      init: the native DP over the seed's own, wider table
      (opt_candidates x opt_walk), in the profiler spans seed.candidates
      and seed.dp.

    Every table is built on the index's device (candidates.candidate_table:
    the kernel on cuda, the numpy builder on cpu); the DP reads the
    index's host arrays.  index: the block's candidates.block_index,
    built here on `device` where the caller has none; table: the
    annealer's table, where the caller has built it.

    Returns (slab, dists): dists is the full-width distance array of a
    wide block, None otherwise.  The native library is built from
    megalania_tpu_torch/native/optparse.cpp on first use; a failed build
    raises."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    wide = len(data) > P.MAX_BLOCK
    if cfg.init == "literal" and not wide:
        return P.literal_slab(len(data)), None
    if index is None:
        index = C_.block_index(data, device)
    if not wide and cfg.init in ("greedy", "mixed"):
        if table is None:
            table = C_.candidate_table(data, cfg.max_candidates,
                                       cfg.max_walk, index)
        return C_.greedy_slab(data, C_.to_numpy(table)), None
    with span("seed.candidates"):
        tab = C_.to_numpy(C_.candidate_table(
            data, cfg.opt_candidates, cfg.opt_walk, index))
    with span("seed.dp"):
        return build_optimal_slab_native(
            data, tab, lc=cfg.lc, passes=cfg.opt_passes,
            win_size=cfg.opt_window, index=index.host, wide=wide)
