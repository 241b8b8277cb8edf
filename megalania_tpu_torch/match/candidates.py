"""Dense per-position match-candidate tables.

The reference enumerates every earlier occurrence of the current bigram
through callback iterators (the reference's src/substring_enumerator.c,
packet_enumerator.c) — unbounded, data-dependent work per query.  The
replacement precomputes, once per block, a dense [n, M] table
of Pareto-optimal (dist, len) candidates: walking occurrences nearest
first, an occurrence enters the table only if it extends further than
every nearer one (a farther, shorter match is dominated: same length is
available nearer, and distance only ever costs more bits).  Rep-distance
eligibility (the reference's long-rep enumeration) is recovered at anneal
time from the rep stack via O(1) LCE queries, so it needs no table.

Build is vectorized numpy over bounded chain-walk rounds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops import tables as T
from .suffix import LCEIndex, build_lce, lce_np


class CandidateTable(NamedTuple):
    dist: np.ndarray  # int32[n, M]  stored-form distance (distance-1)
    length: np.ndarray  # int32[n, M] capped extension length (>=2), 0 = empty
    count: np.ndarray  # int32[n]


def bigram_prev(data: np.ndarray) -> np.ndarray:
    """prev[i] = nearest j < i with the same bigram at j, else -1."""
    n = len(data)
    prev = np.full(n, -1, np.int64)
    if n < 2:
        return prev
    key = data[:-1].astype(np.int64) * 256 + data[1:].astype(np.int64)
    order = np.argsort(key, kind="stable")
    same = key[order[1:]] == key[order[:-1]]
    prev[order[1:]] = np.where(same, order[:-1], -1)
    return prev


def build_candidates(
    data,
    max_candidates: int = 16,
    max_walk: int = 96,
    index: LCEIndex | None = None,
) -> CandidateTable:
    """Build the [n, M] Pareto candidate table for a block."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    M = max_candidates
    dist = np.zeros((n, M), np.int32)
    length = np.zeros((n, M), np.int32)
    count = np.zeros(n, np.int32)
    if n < 2:
        return CandidateTable(dist, length, count)
    if index is None:
        index = build_lce(data)

    prev = bigram_prev(data)
    pos = np.arange(n, dtype=np.int64)
    cur = prev.copy()
    best = np.zeros(n, np.int64)  # best extension seen so far (nearest-first)
    for _ in range(max_walk):
        mask = cur >= 0
        if not mask.any():
            break
        p = pos[mask]
        c = cur[mask]
        ext = np.minimum(lce_np(index, p, c), T.MATCH_LEN_MAX)
        take = (ext >= T.MATCH_LEN_MIN) & (ext > best[mask]) & (
            count[mask] < M
        )
        rows = p[take]
        slots = count[rows]
        dist[rows, slots] = (rows - c[take] - 1).astype(np.int32)
        length[rows, slots] = ext[take].astype(np.int32)
        count[rows] += 1
        b = best[mask]
        best[mask] = np.maximum(b, ext)
        # advance chains; stop ones that already found a full-length match
        nxt = prev[c]
        nxt = np.where(ext >= T.MATCH_LEN_MAX, -1, nxt)
        cur[mask] = nxt
    return CandidateTable(dist=dist, length=length, count=count)


def enumerate_occurrences(data, pos: int, index: LCEIndex | None = None):
    """All (dist, ext) for earlier occurrences of the bigram at pos,
    nearest first (test/spec helper mirroring the reference enumerator)."""
    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    if index is None:
        index = build_lce(data)
    prev = bigram_prev(data)
    out = []
    c = prev[pos]
    while c >= 0:
        ext = int(min(lce_np(index, np.array([pos]), np.array([c]))[0],
                      T.MATCH_LEN_MAX))
        if ext >= T.MATCH_LEN_MIN:
            out.append((pos - c - 1, ext))
        c = prev[c]
    return out


def greedy_slab(data, tab: CandidateTable, min_len: int = 3) -> np.ndarray:
    """Greedy longest-match parse as a packed uint32 slab.

    SURVEY §7's greedy init: at each position take the longest table
    candidate (>= min_len; ties prefer the nearest distance because the
    table is built nearest-first), else a literal.  The annealer then
    refines from a structured parse instead of all-literals — decisive
    at low move budgets on large blocks, where one move per position is
    not enough to discover matches from scratch.
    """
    from ..models import packets as P

    data = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    n = len(data)
    slab = np.asarray(P.literal_slab(n)).copy()
    lens = tab.length
    dists = tab.dist
    best_slot = np.argmax(lens, axis=1) if n else np.zeros(0, np.int64)
    i = 0
    while i < n:
        s = best_slot[i]
        l = int(lens[i, s])
        if l >= min_len:
            l = min(l, n - i)
            if l >= min_len:
                slab[i] = P.pack_np(P.MATCH, int(dists[i, s]), l)
                i += l
                continue
        i += 1
    return slab
