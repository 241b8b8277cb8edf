"""The measured window's arithmetic (frozen; after bench_torch.measure,
whose timed window lies between two device synchronisations and counts
chains x iterations x proposals moves over it).

A window is a run of whole units of work, each ending in a device
synchronisation.  It starts with the first unit and ends with the unit
in which `seconds` have passed, so a rate is all the work of the window
over all of its time.
"""
from __future__ import annotations

import time
from typing import Callable, List


def run_window(unit: Callable[[], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter):
    """Call `unit()` until `seconds` have passed on `clock`; returns
    (the units' results, elapsed seconds)."""
    out: List[object] = []
    t0 = clock()
    while True:
        out.append(unit())
        elapsed = clock() - t0
        if elapsed >= seconds:
            return out, elapsed


def moves(chains: int, proposals: int, iterations: int) -> int:
    """The moves of `iterations` lockstep iterations of a block: one move
    is one exactly re-costed proposal of one chain."""
    return chains * proposals * iterations


def rate(amount: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window")
    return amount / seconds
