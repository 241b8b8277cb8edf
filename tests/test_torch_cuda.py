"""megalania_tpu_torch's CUDA kernels against their plain PyTorch
versions, on the card.  Marked `cuda`: they skip where there is no CUDA
device.  On a machine with a card (jax need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from candidate_cases import CASES, block, index, numpy_table
from repair_cases import C, DATA, EDGE_DATA, kernel_inputs
from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.match import candidates as C_
from megalania_tpu_torch.match import optparse
from megalania_tpu_torch.match.suffix import build_lce
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.ops import (candidates_cuda, log2_cuda, propose_cuda,
                                     repair_cuda)
from megalania_tpu_torch.ops import tables as T

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ctx(dev):
    return engine.make_context(DATA, AnnealConfig(chains=C), dev)


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
    {"edges": True, "lrep_fallback": "match"}],
    ids=["full", "packet", "match", "capture", "substitution", "lc3",
         "lc3-match", "tile_edges"])
def test_repair_kernel_matches_plain(dev, ctx, kw):
    """The kernel equals the plain version on every output.  The inputs
    (tests/repair_cases.py) make the repair change packet lengths;
    `tile_edges` plants long reps where a tile ends, so a changed length
    falls where the walker's lookahead stops."""
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
    got = repair_cuda.repair_cost_cuda(slabs, q, u, c.data_u8, c.cand_dist,
                                       c.cand_len, c.log2, **kw)
    want = repair_cuda.repair_cost_plain(slabs, q, u, c.data, c.cand_dist,
                                         c.cand_len, c.log2, **kw)
    _same(got, want)


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


ENGINE_CONFIGS = {
    "defaults": {},
    "branches": dict(site_mode="packet", proposals=2, accept="mixed",
                     init="mixed_opt", lrep_fallback="litsrep"),
}


@pytest.mark.parametrize("config", list(ENGINE_CONFIGS))
def test_engine_cuda_equals_cpu(dev, config):
    cfg = AnnealConfig(chains=C, iters_per_epoch=4, **ENGINE_CONFIGS[config])
    out = []
    for d in (dev, "cpu"):
        c = engine.make_context(DATA[:256], cfg, d)
        out.append(engine.state_to_numpy(
            engine.run_iters(engine.init_state(c, cfg), c, cfg, 12)))
    for f in out[0]["chains"]:
        np.testing.assert_array_equal(out[0]["chains"][f],
                                      out[1]["chains"][f], err_msg=f)
    for f in out[0]:
        if f != "chains":
            np.testing.assert_array_equal(out[0][f], out[1][f], err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
def test_candidates_kernel_equals_numpy(dev, case):
    """The kernel's table is the numpy builder's, bit for bit."""
    name, M, walk = CASES[case]
    idx = index(name)
    before = candidates_cuda.candidates_cuda.launches
    got = candidates_cuda.candidate_table(
        block(name), M, walk, torch.as_tensor(idx.rank, device=dev),
        torch.as_tensor(idx.sparse, device=dev))
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
    slab = (optparse.seed_slab(data, cfg, index=idx)[0] if init == "optimal"
            else C_.greedy_slab(data, tab))
    want = engine.context_from_numpy(
        data=data.astype(np.int32), rank=idx.rank, sparse=idx.sparse,
        cand_dist=tab.dist, cand_len=tab.length, cand_count=tab.count,
        init_slab=slab, lc=cfg.lc, device=dev)
    for f in engine.BlockContext._fields:
        if f != "device":
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_repair_kernel_at_1m_lc3_reads_device_memory(dev):
    """The 1 MiB, lc=3 deployment (128 chains, the DP seed): the repair
    kernel takes its device-memory branch (the bytes do not fit in shared
    memory), every chain's first full walk costs the seed at the host's
    exact cost, past 2**31, and from its own snapshot at n - 8,192 a
    partial walk with a mutation substituted equals the plain version on
    every chain, output for output."""
    from megalania_tpu_torch.match import optparse_native
    from megalania_tpu_torch.utils import fixedpoint as fp
    n, chains = P.MAX_BLOCK, 128
    data = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
                "rb").read()[:n]
    cfg = AnnealConfig(chains=chains, chain_block=128, lc=3, block_size=n)
    assert not repair_cuda.staging_plan(n, 3).bytes_in_smem
    ctx = engine.make_context(data, cfg, dev)
    staged = dict(repair_cuda.repair_cost_cuda.staged)
    state = engine.init_state(ctx, cfg)
    want = optparse_native.cost_train(np.frombuffer(data, np.uint8),
                                      P.to_u32(ctx.init_slab), lc=3)[0]
    assert want > 1 << 31
    got = {fp.to_int(h, lo) for h, lo in zip(state.chains.cost_hi.tolist(),
                                             state.chains.cost_lo.tolist())}
    assert got == {want}

    rng = np.random.default_rng(15)
    start = n - 8192

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    kw = dict(site_mode=cfg.site_mode, lrep_fallback=cfg.lrep_fallback,
              lc=3)
    tabs = (ctx.cand_dist, ctx.cand_len, ctx.log2)
    snap = repair_cuda.repair_cost_cuda(
        state.chains.slab, ti(rng.integers(0, n, chains)),
        ti(rng.integers(0, n, chains)), ctx.data_u8, *tabs, cap_pos=start,
        **kw)
    args = (snap[0], ti(rng.integers(start, n, chains)),
            ti(rng.integers(start, n, chains)))
    part = dict(start_pos=start, probs_in=snap[3], carry_in=snap[8],
                mut0=ti(P.pack_np(P.SREP, np.zeros(chains, np.int64),
                                  np.ones(chains, np.int64)).view(np.int32)),
                mut1=ti(P.pack_np(P.LREP, rng.integers(0, 4, chains),
                                  np.full(chains, 2)).view(np.int32)), **kw)
    got = repair_cuda.repair_cost_cuda(*args, ctx.data_u8, *tabs, **part)
    plain = repair_cuda.repair_cost_plain(*args, ctx.data, *tabs, **part)
    _same(got, plain)
    assert fp.to_int(got[1][0], got[2][0]) > 1 << 31
    now = repair_cuda.repair_cost_cuda.staged
    assert (now["device"] - staged["device"], now["shared"]) == (
        3, staged["shared"])
