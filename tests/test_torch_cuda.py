"""megalania_tpu_torch's CUDA kernels against their plain PyTorch
versions, on the card.  Marked `cuda`: they skip where there is no CUDA
device.  On a machine with a card (jax need not be installed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.ops import log2_cuda, rank_cuda, repair_cuda
from megalania_tpu_torch.ops import tables as T

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
            "rb").read()[4096:4096 + 1024]
C = 8


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ctx(dev):
    return engine.make_context(DATA, AnnealConfig(chains=C), dev)


def _mutated(ctx, rng):
    n = ctx.data.shape[0]
    slabs = np.broadcast_to(P.to_u32(ctx.init_slab), (C, n)).copy()
    for c in range(C):
        for _ in range(6):
            slabs[c, int(rng.integers(1, n))] = P.pack_np(
                P.LREP, int(rng.integers(0, 4)), 2)
            slabs[c, int(rng.integers(1, n))] = P.pack_np(P.SREP, 0, 1)
    return P.from_u32(slabs, ctx.device)


def _same(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w.cpu()), k


def test_log2_probe_exact(dev):
    raw = log2_cuda.log2_probe_cuda(dev).cpu().numpy()
    exact = log2_cuda.apply_correction(raw, log2_cuda.build_correction(raw))
    np.testing.assert_array_equal(exact[1:], T.LOG2_TABLE_NP[1:])


@pytest.mark.parametrize("kw", [
    {}, {"site_mode": "packet"}, {"lrep_fallback": "litsrep"},
    {"cap_pos": 512}, {"mut": True}, {"lc": 3}],
    ids=["full", "packet", "litsrep", "capture", "substitution", "lc3"])
def test_repair_kernel_matches_plain(dev, ctx, kw):
    rng = np.random.default_rng(5)
    n = ctx.data.shape[0]
    kw = dict(kw)
    lc = kw.get("lc", 0)
    c = ctx if not lc else engine.make_context(
        DATA, AnnealConfig(chains=C, lc=lc), dev)
    slabs = _mutated(c, rng)
    q = torch.as_tensor(rng.integers(0, n // 2, C), dtype=torch.int32,
                        device=dev)
    hi_u = 64 if kw.get("site_mode") == "packet" else n
    u = torch.as_tensor(rng.integers(0, hi_u, C), dtype=torch.int32,
                        device=dev)
    if kw.pop("mut", False):
        q[0] = n - 1
        kw["mut0"] = slabs[:, 3].contiguous()
        kw["mut1"] = slabs[:, 7].contiguous()
    got = repair_cuda.repair_cost_cuda(slabs, q, u, c.data, c.cand_dist,
                                       c.cand_len, c.corr, **kw)
    want = repair_cuda.repair_cost_plain(slabs, q, u, c.data, c.cand_dist,
                                         c.cand_len, c.log2, **kw)
    _same(got, want)


def test_rank_kernel_matches_plain(dev, ctx):
    state = engine.init_state(ctx, AnnealConfig(chains=C))
    ch = state.chains
    n = ctx.data.shape[0]
    q = torch.arange(C, dtype=torch.int32, device=dev) * (n // C)
    from megalania_tpu_torch.anneal import moves
    cands = moves.enumerate_candidates(ch.slab, q, ch.rec_dists, ctx.data,
                                       ctx.rank, ctx.sparse, ctx.cand_dist,
                                       ctx.cand_len, ctx.cand_count)
    args = (ch.rank_probs, moves.pack_candidates(cands).contiguous(),
            ch.rec_ctx, ch.rec_dists,
            *moves.site_bytes(ctx.data, q, ch.rec_dists))
    _same([rank_cuda.rank_cuda(*args, ctx.corr)],
          [rank_cuda.rank_plain(*args)])


def test_engine_cuda_equals_cpu(dev):
    cfg = AnnealConfig(chains=C, iters_per_epoch=4)
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
