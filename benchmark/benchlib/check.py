"""The comparison that decides `correct` (frozen).

Every number compared is a count of faults or a gap of exact integers,
and every limit is 0 (PERF.md gives the readings behind each):
  decode_errors    streams that the plain reference cannot decode to
                   the block they came from;
  lzma_errors      the same, by liblzma (Python's lzma), a second
                   decoder;
  best_cost_gap    |the engine's exact cost of its best parse - the
                   reference's cost of the parse the stream holds|, in
                   1/2048 bit, the widest over the blocks;
  chain_errors     sampled chains whose parse does not reproduce the
                   block;
  chain_cost_gap   |the engine's cost of a sampled chain - the
                   reference's cost of its parse|, the widest;
  chains_uncosted  sampled chains that hold no costed parse (just after
                   an epoch restart), so that the chain comparison
                   cannot pass with nothing compared;
  moves_gap        |moves the engine counted - moves the harness asked
                   for|, the widest over blocks (a step that is skipped
                   counts none);
  chains_unmoved   chains whose parse never moved in the window
                   (cells.MoveWatch), summed over the blocks: the
                   engine counts moves whatever becomes of the chains,
                   so a step that leaves them as they were, or anneals
                   only some of them, shows here;
  outputs_differ   outputs of one file in one run that differ from the
                   first (the same input and seed give the same bytes);
  ranks_disagree   in a cell of several cards, the ranks whose answer
                   (the best parse's cost, the sha256 of the best parse
                   and of the stream it emitted) differs from rank 0's:
                   every chain rank of a block holds the block's best;
  exchange_gap     in a cell of several cards, |iterations run - the
                   best exchanges made (mesh.exchange_best's own
                   counter)|, the widest over the ranks: from the DP
                   seed no chain beats the initial best, so every rank
                   holds the same best with no exchange at all, and
                   only the count shows one left out or thinned;
  capture_gap      the same for the capture position's all-reduce MIN
                   over the chain ranks (cells.CaptureCount), one an
                   iteration under the sweep schedule.

In a cell of several cards each rank checks its own outputs (its stream,
its sampled chains, its moves) and `fold` joins the ranks' numbers:
counts are summed, gaps take the widest.
"""
from __future__ import annotations

import lzma
from typing import List, Optional, Sequence, Tuple

from . import reference as R

LIMITS = {
    "decode_errors": 0, "lzma_errors": 0, "best_cost_gap": 0,
    "chain_errors": 0, "chain_cost_gap": 0, "chains_uncosted": 0,
    "moves_gap": 0, "chains_unmoved": 0, "outputs_differ": 0,
    "ranks_disagree": 0, "exchange_gap": 0, "capture_gap": 0,
}
GAPS = ("best_cost_gap", "chain_cost_gap", "moves_gap", "exchange_gap",
        "capture_gap")


def _lzma_ok(stream: bytes, data: bytes) -> bool:
    try:
        return lzma.decompress(stream, format=lzma.FORMAT_ALONE) == data
    except lzma.LZMAError:
        return False


def streams(blocks: Sequence[bytes], outs: Sequence[bytes],
            costs: Sequence[int], f32: bool = False) -> dict:
    """Decode each block's stream with the reference and compare the
    cost of the parse it holds with the engine's.  f32: the reference's
    cost summed in float32 (the control)."""
    dec_err = lz_err = 0
    gap = 0
    for data, out, cost in zip(blocks, outs, costs):
        lz_err += not _lzma_ok(out, data)
        try:
            d = R.decode(out, f32=f32)
        except R.StreamError:
            dec_err += 1
            continue
        if d.data != data:
            dec_err += 1
            continue
        gap = max(gap, abs(int(cost) - d.cost))
    if len(outs) != len(blocks):
        dec_err += abs(len(outs) - len(blocks))
    return {"decode_errors": dec_err, "lzma_errors": lz_err,
            "best_cost_gap": gap}


def chains(data: bytes, sample: List[Tuple[object, Optional[int]]],
           lc: int) -> dict:
    """Cost each sampled chain's parse (packed words, engine cost; None
    for a chain that holds no costed parse, after an epoch restart)."""
    errors, gap, uncosted = 0, 0, 0
    for words, cost in sample:
        if cost is None:
            uncosted += 1
            continue
        try:
            ref = R.parse_cost(data, R.parse_packed(words), lc=lc)
        except R.StreamError:
            errors += 1
            continue
        gap = max(gap, abs(int(cost) - ref))
    return {"chain_errors": errors, "chain_cost_gap": gap,
            "chains_uncosted": uncosted}


def ranks(answers: Sequence[tuple]) -> dict:
    """The ranks whose answer differs from rank 0's."""
    return {"ranks_disagree": sum(a != answers[0] for a in answers[1:])}


def fold(per_rank: Sequence[dict]) -> dict:
    """The numbers of several ranks as one: counts summed, gaps the
    widest."""
    out = {}
    for checks in per_rank:
        for k, v in checks.items():
            out[k] = (max(out.get(k, v), v) if k in GAPS
                      else out.get(k, 0) + v)
    return out


def verdict(checks: dict) -> bool:
    return all(checks[k] <= lim for k, lim in LIMITS.items() if k in checks)


def lines(checks: dict) -> List[str]:
    """One line per number compared: its name, value and limit."""
    return [f"check {k} = {checks[k]} (limit {lim})"
            for k, lim in LIMITS.items() if k in checks]


def table(checks: dict) -> dict:
    return {k: {"value": checks[k], "limit": lim}
            for k, lim in LIMITS.items() if k in checks}
