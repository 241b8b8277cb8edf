"""megalania_tpu_torch on the card against its plain PyTorch versions
and its CPU path: every comparison of a card's output with a plain or a
CPU output lives here, at small shapes and at the deployments' shapes.
Marked `cuda`: they skip where there is no CUDA device.  On a machine
with a card (jax need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools
import os

import numpy as np
import pytest
import torch

from candidate_cases import CASES, WIDE_CASES, block, index, numpy_table
from repair_cases import (C, DATA, EDGE_DATA, first_proposal, kernel_inputs,
                          repair_rows)
from megalania_tpu_torch import compressor
from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.match import candidates as C_
from megalania_tpu_torch.match import optparse, optparse_native
from megalania_tpu_torch.match.suffix import build_lce
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.ops import (candidates_cuda, log2_cuda, propose_cuda,
                                     repair_cuda, scan_cost)
from megalania_tpu_torch.ops import tables as T
from megalania_tpu_torch.parallel import blocks
from megalania_tpu_torch.utils import fixedpoint as fp

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tools", "corpus")
LIBC = open(os.path.join(CORPUS, "libc.so"), "rb").read()
SURVEY = open(os.path.join(CORPUS, "survey.md"), "rb").read()
EDGES512 = [*range(8), *range(504, 512)]     # rows of both waves
# The main path's shapes and the deployments': id -> (bytes, AnnealConfig
# fields, the rows the plain repair walks, the positions it walks at the
# block's end, the iterations run first).  64 KiB at 128 chains (the
# shipped defaults); 256 KiB and 1 MiB, whose bytes do not fit in shared
# memory; 512 chains, two waves of blocks; lc=3; bench.py's headline
# shape, 2 KiB at 512 chains from init=mixed, also past its first sweep.
SHAPES = {
    "64k-c128": (LIBC[:1 << 16], dict(chains=128), range(128), 8192, 0),
    "256k-c8": (LIBC[:1 << 18], dict(chains=8), range(8), 2048, 0),
    "64k-c512": (LIBC[:1 << 16], dict(chains=512, chain_block=512),
                 EDGES512, 4096, 0),
    "64k-lc3": (LIBC[:1 << 16], dict(chains=128, lc=3, init="mixed",
                                     accept="greedy"),
                [0, 1, 2, 3, 124, 125, 126, 127], 4096, 256),
    "2k-c512": (SURVEY[:2048], dict(chains=512, chain_block=512,
                                    init="mixed"), EDGES512, 1024, 0),
    "2k-c512-iterated": (SURVEY[:2048], dict(chains=512, chain_block=512,
                                             init="mixed"),
                         EDGES512, 1024, 40),
    "1m-lc3": (LIBC[:1 << 20], dict(chains=128, lc=3, block_size=1 << 20),
               range(128), 8192, 0),
}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ctx(dev):
    return engine.make_context(DATA, AnnealConfig(chains=C), dev)


@functools.cache
def deployment(shape: str, dev):
    """(context, config, fresh state) of a SHAPES entry on `dev`."""
    data, fields = SHAPES[shape][:2]
    cfg = AnnealConfig(**fields)
    ctx = engine.make_context(data, cfg, dev)
    return ctx, cfg, engine.init_state(ctx, cfg)


def _same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), k


def _exact(dev):
    return torch.as_tensor(T.LOG2_TABLE_I32, device=dev)


def test_log2_probe_exact(dev):
    corr, raw, _ = log2_cuda.log2_correction_cuda(_exact(dev))
    exact = log2_cuda.apply_correction(raw.cpu().numpy(), corr.cpu().numpy())
    np.testing.assert_array_equal(exact[1:], T.LOG2_TABLE_NP[1:])


def test_log2_correction_matches_plain(dev):
    """The kernel's words are the plain version's on the kernel's own raw
    costs, its status is their deviation range, and one call is one
    launch."""
    exact = _exact(dev)
    before = log2_cuda.log2_correction_cuda.launches
    corr, raw, status = log2_cuda.log2_correction_cuda(exact)
    assert log2_cuda.log2_correction_cuda.launches == before + 1
    assert corr.is_cuda and raw.is_cuda
    assert torch.equal(corr, log2_cuda.correction_plain(raw, exact))
    diff = log2_cuda.log2_probe_plain(dev).long() - raw.long()
    lo, hi = status.tolist()
    assert [lo, hi] == [int(diff.min()), int(diff.max())]
    assert -1 <= lo <= hi <= 1
    assert torch.equal(log2_cuda.log2_correction(exact), corr)
    assert log2_cuda.log2_correction_cuda.launches == before + 2


def test_log2_correction_raises_beyond_one(dev):
    exact = _exact(dev)
    _, raw, _ = log2_cuda.log2_correction_cuda(exact)
    same = torch.nonzero(exact[1:] == raw[1:]).flatten()
    bad = exact.clone()
    bad[1 + int(same[700])] += 2
    with pytest.raises(RuntimeError, match="deviates by >1"):
        log2_cuda.log2_correction_cuda(bad)


@pytest.mark.parametrize("kw", [
    {}, {"site_mode": "packet"}, {"lrep_fallback": "match"},
    {"cap_pos": 512}, {"mut": True}, {"lc": 3},
    {"lc": 3, "lrep_fallback": "match"},
    {"edges": True, "lrep_fallback": "match"}, {"partial": True}],
    ids=["full", "packet", "match", "capture", "substitution", "lc3",
         "lc3-match", "tile_edges", "partial"])
def test_repair_kernel_matches_plain(dev, ctx, kw):
    """The kernel equals the plain version on every output.  The inputs
    (tests/repair_cases.py) make the repair change packet lengths;
    `tile_edges` plants long reps where a tile ends, so a changed length
    falls where the walker's lookahead stops; `partial` re-costs from the
    kernel's own snapshot, and equals the full walk it replaces."""
    rng = np.random.default_rng(5)
    kw = dict(kw)
    lc = kw.get("lc", 0)
    edges = kw.pop("edges", False)
    c = ctx if not (lc or edges) else engine.make_context(
        EDGE_DATA if edges else DATA, AnnealConfig(chains=C, lc=lc), dev)
    n = c.data.shape[0]
    slabs, q, u = kernel_inputs(c, rng, edges=edges,
                                packet_sites=kw.get("site_mode") == "packet")
    slabs = P.from_u32(slabs, dev)
    q, u = (torch.as_tensor(v, device=dev) for v in (q, u))
    if kw.pop("mut", False):
        q[0] = n - 1
        kw["mut0"] = slabs[:, 3].contiguous()
        kw["mut1"] = slabs[:, 7].contiguous()
    tabs = (c.cand_dist, c.cand_len, c.log2)
    full = None
    if kw.pop("partial", False):
        snap = repair_cuda.repair_cost_cuda(slabs, q, u, c.data_u8, *tabs,
                                            cap_pos=256)
        slabs = snap[0]
        q, u = (torch.as_tensor(rng.integers(lo, n, C), dtype=torch.int32,
                                device=dev) for lo in (384, 256))
        full = repair_cuda.repair_cost_cuda(slabs, q, u, c.data_u8, *tabs)
        kw.update(start_pos=256, cap_pos=512, probs_in=snap[3],
                  carry_in=snap[8])
    got = repair_cuda.repair_cost_cuda(slabs, q, u, c.data_u8, *tabs, **kw)
    want = repair_cuda.repair_cost_plain(slabs, q, u, c.data, *tabs, **kw)
    _same(got, want)
    if full is not None:        # all but the snapshot, taken elsewhere
        _same(got[:3] + got[4:8], full[:3] + full[4:8])


@pytest.mark.parametrize("state", ["fresh", "iterated"])
@pytest.mark.parametrize("site", ["sweep", "byte", "packet"])
@pytest.mark.parametrize("lc,proposals", [(0, 1), (0, 2), (3, 1), (3, 2)],
                         ids=["lc0-p1", "lc0-p2", "lc3-p1", "lc3-p2"])
def test_propose_kernel_matches_plain(dev, lc, proposals, site, state):
    """Every output of the proposal kernel equals propose_plain's on the
    same CUDA tensors: the initial state with uniform probabilities
    (tied metrics) and the state after three iterations."""
    cfg = AnnealConfig(chains=C, lc=lc, proposals=proposals,
                       iters_per_epoch=4)
    c = engine.make_context(DATA, cfg, dev)
    st = engine.init_state(c, cfg)
    if state == "fresh":
        st = st._replace(chains=st.chains._replace(
            rank_probs=torch.full_like(st.chains.rank_probs, T.PROB_INIT)))
    else:
        st = engine.run_iters(st, c, cfg, 3)
    n = c.data.shape[0]
    q = torch.as_tensor(np.random.default_rng(9).integers(0, n, C),
                        dtype=torch.int32, device=dev)
    q[0], q[1] = n - 1, 0
    ch = st.chains
    args = (ch.key, st.skey, ch.slab, q, ch.rec_ctx, ch.rec_dists,
            ch.rank_probs, ch.live_count, c)
    kw = dict(proposals=proposals, top_k=cfg.top_k, sublens=cfg.sublens,
              lc=lc, **{"sweep": dict(u_lo=256, span=256),
                        "byte": dict(span=n), "packet": dict(span=None)}[site])
    before = propose_cuda.propose_cuda.launches
    got = propose_cuda.propose_cuda(*args, **kw)
    assert propose_cuda.propose_cuda.launches == before + 1
    _same(got, propose_cuda.propose_plain(*args, **kw))


# id -> (bytes, AnnealConfig fields over 8 chains, 4 iterations an epoch)
ENGINE_CONFIGS = {
    "defaults": (DATA[:256], {}),
    "branches": (DATA[:256], dict(site_mode="packet", proposals=2,
                                  accept="mixed", init="mixed_opt",
                                  lrep_fallback="litsrep")),
    "lc3": (DATA[:256], dict(lc=3)),
    "2k-c128": (LIBC[16384:16384 + 2048], dict(chains=128)),
    "container": (LIBC[32768:32768 + 4 * 2048 + 700],
                  dict(block_size=2048)),
}


@pytest.mark.parametrize("config", list(ENGINE_CONFIGS))
def test_engine_cuda_equals_cpu(dev, config):
    """Twelve iterations on the card give the CPU's state, field for
    field, and the best parse's cost on the card is the one scan_cost
    finds on the card and the native coster on the host.  `container`:
    four 2 KiB blocks and a tail through compressor.compress, three
    iterations a block, give the CPU's bytes."""
    data, fields = ENGINE_CONFIGS[config]
    cfg = AnnealConfig(**{"chains": C, "iters_per_epoch": 4, **fields})
    if config == "container":
        got, want = (compressor.compress(data, cfg, total_moves=5 * 3 * C,
                                         device=d) for d in (dev, "cpu"))
        assert got == want and compressor.decompress(got) == data
        assert len(blocks.unpack_container(got)) == 5
        return
    out = []
    for d in ("cpu", dev):
        c = engine.make_context(data, cfg, d)
        out.append(engine.run_iters(engine.init_state(c, cfg), c, cfg, 12))
    want, got = (engine.state_to_numpy(s) for s in out)
    for f in got["chains"]:
        np.testing.assert_array_equal(got["chains"][f], want["chains"][f],
                                      err_msg=f)
    for f in got:
        if f != "chains":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    best = out[1]
    hi, lo, _, live = scan_cost.parse_cost_exact(best.best_slab, c.data,
                                                 cfg.lc)
    assert live.device == dev and bool(live.any())
    host = optparse_native.cost_train(np.frombuffer(data, np.uint8),
                                      P.to_u32(best.best_slab), lc=cfg.lc)[0]
    assert fp.to_int(hi, lo) == fp.to_int(best.best_hi, best.best_lo) == host


@pytest.mark.parametrize("case", [*CASES, *WIDE_CASES])
def test_candidates_kernel_equals_numpy(dev, case):
    """The kernel's table is the numpy builder's, bit for bit."""
    name, M, walk = {**CASES, **WIDE_CASES}[case]
    idx = index(name)
    before = candidates_cuda.candidates_cuda.launches
    got = C_.candidate_table(block(name), M, walk, C_.BlockIndex(
        idx, torch.as_tensor(idx.rank, device=dev),
        torch.as_tensor(idx.sparse, device=dev)))
    assert (candidates_cuda.candidates_cuda.launches
            == before + (len(block(name)) >= 2))
    for g, w in zip(got, numpy_table(case)):
        assert g.is_cuda
        assert torch.equal(g.cpu(), torch.from_numpy(w))


@pytest.mark.parametrize("init,kernels", [("optimal", 2), ("mixed", 1)])
def test_make_context_on_card_equals_host(dev, init, kernels):
    """make_context on the card builds the same BlockContext as the
    host's numpy arrays through context_from_numpy, with one candidate
    kernel for the annealer's table and one for the seed's."""
    data = np.frombuffer(
        open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
             "rb").read()[:16384], np.uint8)
    cfg = AnnealConfig(chains=C, init=init)
    before = candidates_cuda.candidates_cuda.launches
    got = engine.make_context(data, cfg, dev)
    assert candidates_cuda.candidates_cuda.launches == before + kernels
    idx = build_lce(data)
    tab = C_.build_candidates(data, cfg.max_candidates, cfg.max_walk, idx)
    slab, _ = optparse.seed_slab(data, cfg)
    want = engine.context_from_numpy(
        data=data.astype(np.int32), rank=idx.rank, sparse=idx.sparse,
        cand_dist=tab.dist, cand_len=tab.length, cand_count=tab.count,
        init_slab=slab, lc=cfg.lc, device=dev)
    for f in engine.BlockContext._fields:
        if f != "device":
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("shape", list(SHAPES))
def test_repair_kernel_at_deployment_shapes(dev, shape):
    """At each shape, after its iterations: the best parse's cost on the
    card is the host's exact cost (optparse_native.cost_train, no code
    shared with the card), past 2**31 at 1 MiB; from the fresh state,
    every chain costs its start, the seed or literals; the kernel reads the
    bytes from shared memory up to 64 KiB and from device memory above;
    and from its own snapshot, with a mutation substituted, it equals the
    plain version on the rows held, output for output."""
    data, _, rows, window, iters = SHAPES[shape]
    ctx, cfg, state = deployment(shape, dev)
    arr = np.frombuffer(data, np.uint8)
    if iters:
        state = engine.run_iters(state, ctx, cfg, iters)
    want = optparse_native.cost_train(arr, P.to_u32(state.best_slab),
                                      lc=cfg.lc)[0]
    assert fp.to_int(state.best_hi, state.best_lo) == want
    assert want > 1 << 31 or len(data) < 1 << 20
    if not iters:       # every chain costs its start: the seed or literals
        seed, lit = (optparse_native.cost_train(arr, s, lc=cfg.lc)[0]
                     for s in (P.to_u32(ctx.init_slab),
                               P.literal_slab(len(arr))))
        costs = {fp.to_int(h, lo) for h, lo in zip(
            state.chains.cost_hi.tolist(), state.chains.cost_lo.tolist())}
        assert costs == ({seed, lit} if cfg.init in ("mixed", "mixed_opt")
                         else {seed})
    plan = repair_cuda.staging_plan(len(data), cfg.lc)
    assert plan.bytes_in_smem == (len(data) <= 1 << 16)
    before = dict(repair_cuda.repair_cost_cuda.staged)
    _same(*repair_rows(ctx, cfg, state, rows, window,
                       np.random.default_rng(15)))
    now = repair_cuda.repair_cost_cuda.staged
    branch = "shared" if plan.bytes_in_smem else "device"
    assert {k: now[k] - before[k] for k in now} == {
        k: 2 * (k == branch) for k in now}


@pytest.mark.parametrize("shape", ["64k-c128", "64k-c512", "64k-lc3",
                                   "2k-c512"])
def test_propose_kernel_at_deployment_shapes(dev, shape):
    """The proposal stage of the main path's first iteration at each
    shape: every output of the kernel equals propose_plain's."""
    ctx, cfg, state = deployment(shape, dev)
    args, kw = first_proposal(ctx, state, cfg)
    _same(propose_cuda.propose_cuda(*args, **kw),
          propose_cuda.propose_plain(*args, **kw))
