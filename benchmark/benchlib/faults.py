"""Faults planted under the timed path: each breaks one thing of the
program for the runs made inside it, and a run with it must come out
not correct.  The CPU tests (tests/test_bench_faults.py,
test_bench_ranks.py) and the readings on the card (control.py --faults)
plant the same ones.  In a cell of several cards a fault is planted in
the ranks that the run names (runner.drive).  The last few
(`PROCESS`) break a rank's process, not its answers: the runner must
then end the run with no result, or keep the ranks in step."""
from __future__ import annotations

import contextlib
import os
import signal
import time

import torch

from .cells import patched


def _chains_step(change):
    """Replace engine._chains_iter, the chains' step inside every
    iteration, by change(state, its result's chains)."""
    from megalania_tpu_torch.anneal import engine

    def make(orig):
        def step(state, *a, **kw):
            chains, *rest = orig(state, *a, **kw)
            return (change(state.chains, chains), *rest)
        return step
    return patched(engine, "_chains_iter", make)


def chains_stuck():
    """Every step leaves the chains as they were (the mutation dropped,
    or every proposal rejected) while the counters advance."""
    return _chains_step(lambda old, new: old)


def half_chains():
    """Half the chains are never annealed: their parses and costs stay
    as they were at every step."""
    def change(old, new):
        h = new.slab.shape[0] // 2

        def keep(n, o):
            return torch.cat([n[:h], o[h:]])
        return new._replace(slab=keep(new.slab, old.slab),
                            cost_hi=keep(new.cost_hi, old.cost_hi),
                            cost_lo=keep(new.cost_lo, old.cost_lo))
    return _chains_step(change)


def step_skipped():
    """engine.run_iters returns its state: the steps are skipped."""
    from megalania_tpu_torch.anneal import engine
    return patched(engine, "run_iters",
                   lambda orig: lambda state, *a, **kw: state)


def stream_byte():
    """A byte of every emitted stream altered where it is produced."""
    from megalania_tpu_torch.runtime import emit

    def make(orig):
        def altered(*a, **kw):
            s = bytearray(orig(*a, **kw))
            s[len(s) // 2] ^= 0x20
            return bytes(s)
        return altered
    return patched(emit, "emit", make)


def exchange_skipped():
    """The exchange between the chain ranks left out: each rank keeps
    the best of its own chains (parallel.mesh.exchange_best)."""
    from megalania_tpu_torch.parallel import mesh
    return patched(mesh, "exchange_best",
                   lambda orig: lambda slab, hi, lo, *a, **kw: (slab, hi, lo))


@contextlib.contextmanager
def capture_skipped():
    """The capture position's all-reduce MIN over the chain ranks left
    out (engine._chains_iter): each rank captures at its own chains'
    lowest site.  The engine's `dist` is replaced by a stand-in whose
    all_reduce MIN does nothing; planted in every rank, or the ranks'
    collectives fall out of step."""
    from megalania_tpu_torch.anneal import engine
    real = engine.dist

    class Dist:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def all_reduce(tensor, *a, **kw):
            if kw.get("op") == real.ReduceOp.MIN:
                return None
            return real.all_reduce(tensor, *a, **kw)

    engine.dist = Dist()
    try:
        yield
    finally:
        engine.dist = real


def _best_altered(change):
    from megalania_tpu_torch.anneal import engine

    def make(orig):
        def step(*a, **kw):
            return change(orig(*a, **kw))
        return step
    return patched(engine, "anneal_iteration", make)


def best_parse():
    """The best parse altered after every step: its first packet one
    byte longer."""
    def change(out):
        slab = out.best_slab.clone()
        slab[0] = slab[0] + (1 << 20)
        return out._replace(best_slab=slab)
    return _best_altered(change)


def best_cost():
    """The best parse's cost raised by 1/2048 bit after every step."""
    return _best_altered(lambda out: out._replace(best_lo=out.best_lo + 1))


PLANTS = {"chains_stuck": chains_stuck, "half_chains": half_chains,
          "step_skipped": step_skipped, "stream_byte": stream_byte,
          "exchange_skipped": exchange_skipped,
          "capture_skipped": capture_skipped, "best_parse": best_parse,
          "best_cost": best_cost}


def _in_window(act):
    """Do `act()` at the second engine.run_iters call, the window's
    first segment (the first is the warm-up)."""
    from megalania_tpu_torch.anneal import engine
    calls = [0]

    def make(orig):
        def run(*a, **kw):
            calls[0] += 1
            if calls[0] == 2:
                act()
            return orig(*a, **kw)
        return run
    return patched(engine, "run_iters", make)


def _clock(rate: float):
    """The window's clock runs `rate` times as fast on this rank as on
    the others."""
    from . import window

    def make(orig):
        def run(unit, seconds, **kw):
            return orig(unit, seconds,
                        clock=lambda: time.perf_counter() * rate, **kw)
        return run
    return patched(window, "run_window", make)


def _raises():
    raise RuntimeError("a planted failure")


PROCESS = {
    # alone, this rank would close the window after one segment
    "clock_fast": lambda: _clock(1000.0),
    # alone, it would never close it
    "clock_slow": lambda: _clock(1e-6),
    "rank_killed": lambda: _in_window(
        lambda: os.kill(os.getpid(), signal.SIGKILL)),
    "rank_raises": lambda: _in_window(_raises),
    "rank_hangs": lambda: _in_window(lambda: time.sleep(3600)),
}


@contextlib.contextmanager
def planted(name: str):
    with {**PLANTS, **PROCESS}[name]():
        yield
