"""Faults planted under the timed path: each breaks one thing of the
program for the runs made inside it, and a run with it must come out
not correct.  The CPU tests (tests/test_bench_faults.py) and the
readings on the card (control.py --faults) plant the same ones."""
from __future__ import annotations

import contextlib

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


PLANTS = {"chains_stuck": chains_stuck, "half_chains": half_chains,
          "step_skipped": step_skipped, "stream_byte": stream_byte}


@contextlib.contextmanager
def planted(name: str):
    with PLANTS[name]():
        yield
