"""The port's spans (megalania_tpu_torch.utils.profiling.span) on the CPU:
nothing without a profiler, plain host events under one, and the spans
that compress_block and compress put at the layer boundaries of the host
seed and context, the chains' first walk, the engine iteration, the
block queue and the emission."""
import contextlib
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from megalania_tpu_torch import compressor
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
            "rb").read()[4096:4096 + 160]
CFG = AnnealConfig(chains=8, max_candidates=8, max_walk=48, top_k=12,
                   opt_candidates=8, opt_walk=48, init="optimal")
STAGES = ("iter.draw", "iter.cost", "iter.accept", "iter.best",
          "iter.restart")
PROGRAM = STAGES + ("context.index", "seed.candidates", "seed.dp",
                    "init_state", "emit", "block.wait")
ITERS, SEGMENT = 4, 2


def spans(prof):
    """(name, start_ns, end_ns) of the program's spans, in time order,
    from the profiler's raw events (the plain versions' hundreds of
    thousands of operations make prof.events() take a minute); each a
    host event that is no user annotation."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in PROGRAM:
            assert e.device_type() == torch.autograd.DeviceType.CPU
            assert not e.is_user_annotation()
            out.append((e.name(), e.start_ns(), e.end_ns()))
    return sorted(out, key=lambda s: s[1])


@pytest.fixture(scope="module")
def block_run():
    """The spans of one block of ITERS iterations in segments of SEGMENT,
    profiled."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = compressor.compress_block(
            DATA, CFG, total_moves=CFG.chains * CFG.proposals * ITERS,
            segment_iters=SEGMENT, device="cpu")
    assert res.moves == CFG.chains * CFG.proposals * ITERS
    return spans(prof)


def test_span_without_a_profiler_records_nothing():
    assert not torch.autograd._profiler_enabled()
    # one shared no-op context, whatever the name: nothing is built
    a, b = profiling.span("iter.draw"), profiling.span("emit")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_is_a_host_event_and_no_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer.stage"):
            with profiling.span("inner.stage"):
                torch.ones(8).sum()
    evs = {e.name: e for e in prof.events()}
    for name in ("outer.stage", "inner.stage"):
        assert evs[name].is_user_annotation is False
        assert evs[name].device_type == torch.autograd.DeviceType.CPU
    outer, inner = evs["outer.stage"], evs["inner.stage"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_five_stages_tile_each_iteration_in_order(block_run):
    seq = [n for n, _, _ in block_run if n.startswith("iter.")]
    assert seq == list(STAGES) * ITERS


def test_program_spans_do_not_overlap(block_run):
    """No program span encloses another: the iteration's stages are the
    outermost program operations, and so name the device's idle gaps."""
    assert block_run
    for (n0, _, e0), (n1, s1, _) in zip(block_run, block_run[1:]):
        assert e0 <= s1, (n0, n1)


def test_seed_and_context_spans_once_per_block(block_run):
    seq = [n for n, _, _ in block_run]
    for name in ("context.index", "seed.candidates", "seed.dp",
                 "init_state", "emit"):
        assert seq.count(name) == 1, name
    assert seq.index("context.index") < seq.index("seed.candidates") \
        < seq.index("seed.dp") < seq.index("init_state") \
        < seq.index("iter.draw")
    assert seq[-1] == "emit"


def test_block_wait_per_segment_and_the_final_readback(block_run):
    seq = [n for n, _, _ in block_run]
    assert seq.count("block.wait") == ITERS // SEGMENT + 1
    # each segment's wait follows its last iteration; the readback
    # precedes the emission
    assert seq[-2:] == ["block.wait", "emit"]
    waits = [i for i, n in enumerate(seq) if n == "block.wait"]
    assert all(seq[i - 1] == "iter.restart" for i in waits[:-1])


def test_init_state_span_holds_the_first_walk(monkeypatch):
    """init_state's span encloses the chains' fill and their first full
    walk: the one repair pass before the first iteration."""
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.ops import repair_cuda
    ctx = engine.make_context(DATA, CFG, "cpu")
    walks = []
    plain = repair_cuda.repair_cost_plain

    def watch(*a, **kw):
        walks.append(torch.autograd._profiler_enabled())
        return plain(*a, **kw)
    monkeypatch.setattr(repair_cuda, "repair_cost_plain", watch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outside.init"):
            state = engine.init_state(ctx, CFG)
    assert walks == [True] and state.moves_done == 0
    evs = {e.name: e for e in prof.events()
           if e.name in ("outside.init", "init_state")}
    inner, outer = evs["init_state"], evs["outside.init"]
    assert not inner.is_user_annotation
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def test_dp_only_blocks_carry_the_seed_and_emit_spans():
    cfg = AnnealConfig(block_size=80, opt_candidates=8, opt_walk=48,
                       init="optimal")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = compressor.compress(DATA, cfg, total_moves=0, device="cpu")
    assert compressor.decompress(blob) == DATA
    seq = [n for n, _, _ in spans(prof)]
    assert seq == ["seed.candidates", "seed.dp", "emit"] * 2


def test_span_names_keep_out_of_the_kernel_and_harness_names(block_run):
    seen = {n for n, _, _ in block_run}
    assert seen == set(PROGRAM)
    for name in seen:
        assert "repair" not in name and "propose" not in name
        assert not name.startswith("bench.")
