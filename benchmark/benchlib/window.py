"""The measured window's arithmetic (frozen; after bench_torch.measure,
whose timed window lies between two device synchronisations and counts
chains x iterations x proposals moves over it).

A window is a run of whole units of work, each ending in a device
synchronisation.  It starts with the first unit and ends with the unit
in which `seconds` have passed, so a rate is all the work of the window
over all of its time.  Where several processes share the work (one a
card), `agree` turns each one's verdict into the group's, so that every
process runs the same units.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional


def run_window(unit: Callable[[], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               agree: Optional[Callable[[bool], bool]] = None):
    """Call `unit()` until `seconds` have passed on `clock`; returns
    (the units' results, elapsed seconds).  `agree(done)`, where given,
    is called after every unit with this process's verdict and returns
    the one that all processes take (True once any of them is done)."""
    out: List[object] = []
    t0 = clock()
    while True:
        out.append(unit())
        elapsed = clock() - t0
        done = elapsed >= seconds
        if agree is not None:
            done = agree(done)
        if done:
            return out, elapsed


def moves(chains: int, proposals: int, iterations: int) -> int:
    """The moves of `iterations` lockstep iterations of a block: one move
    is one exactly re-costed proposal of one chain."""
    return chains * proposals * iterations


def rate(amount: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window")
    return amount / seconds
