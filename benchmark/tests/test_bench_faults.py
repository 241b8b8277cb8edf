"""A run with the timed path broken underneath must come out not
correct: a step skipped, the chains left as they were while the counters
advance, half the chains never annealed, and an answer altered where it
is produced (a stream byte, the best parse, its cost, a container byte).
The harness runs on the CPU here (its look for a card skipped), at a
tiny size."""
import time

import pytest

from benchconf import tiny
from benchlib import faults, runner

SEED = 2 ** 31 + 77
CELLS = ["elf64k-anneal", "text2k-anneal", "elf128k-file"]


def _run(workload, **kw):
    spec, wl, conf, mix = tiny(workload, **kw)
    res, jax = runner.run_cell(spec, wl, conf, mix, SEED, 0.3, False,
                               time.time(), device_type="cpu")
    assert not jax
    return res


def _values(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_are_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert _values(res)["chains_unmoved"] == 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault,number", [
    ("step_skipped", "moves_gap"), ("chains_stuck", "chains_unmoved"),
    ("half_chains", "chains_unmoved")])
def test_chains_left_as_they_were(workload, fault, number):
    """A step that returns its state unchanged, one that leaves the
    chains as they were while the counters advance, and one that
    anneals only half the chains."""
    with faults.planted(fault):
        res = _run(workload)
    assert not res["correct"] and _values(res)[number] > 0


def test_an_empty_chain_comparison_is_not_correct():
    """Sampled chains that hold no costed parse are counted, so that the
    chain comparison cannot pass with nothing compared."""
    from benchlib import check
    c = check.chains(b"ab", [(None, None), (None, None)], 0)
    assert c["chains_uncosted"] == 2 and not check.verdict(c)


def test_stream_byte_altered():
    with faults.planted("stream_byte"):
        res = _run("elf64k-anneal")
    v = _values(res)
    assert not res["correct"] and v["decode_errors"] + v["lzma_errors"] > 0


def test_best_parse_altered(monkeypatch):
    from megalania_tpu_torch.anneal import engine
    real = engine.anneal_iteration

    def altered(state, ctx, cfg, group=None):
        out = real(state, ctx, cfg, group)
        slab = out.best_slab.clone()
        slab[0] = slab[0] + (1 << 20)     # the first packet one byte longer
        return out._replace(best_slab=slab)
    monkeypatch.setattr(engine, "anneal_iteration", altered)
    res = _run("elf64k-anneal")
    assert not res["correct"]


def test_best_cost_altered(monkeypatch):
    from megalania_tpu_torch.anneal import engine
    real = engine.anneal_iteration

    def altered(state, ctx, cfg, group=None):
        out = real(state, ctx, cfg, group)
        return out._replace(best_lo=out.best_lo + 1)
    monkeypatch.setattr(engine, "anneal_iteration", altered)
    res = _run("elf64k-anneal")
    assert not res["correct"] and _values(res)["best_cost_gap"] > 0


def test_container_byte_altered(monkeypatch):
    from megalania_tpu_torch import compressor
    real = compressor.compress

    def altered(*a, **kw):
        s = bytearray(real(*a, **kw))
        s[-3] ^= 0x01
        return bytes(s)
    monkeypatch.setattr(compressor, "compress", altered)
    res = _run("elf128k-file")
    assert not res["correct"]
