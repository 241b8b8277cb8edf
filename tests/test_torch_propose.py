"""The proposal stage of megalania_tpu_torch (ops/propose_cuda.py
propose_plain, the plain version of the proposal kernel) against the
reference's own sequence in megalania_tpu, run with jax on the same
inputs: the key splits of the iteration (anneal/engine.py _chains_iter),
enumeration and the mutation choice under vmap, the Pallas ranking
kernel in interpret mode, the site draws and the acceptance uniform.
Every output is compared exactly (tolerance 0)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megalania_tpu.anneal import engine as JE, moves as JM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu.models import packets as JP
from megalania_tpu.ops import pallas_rank
from megalania_tpu.ops import tables as JT
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.ops import propose_cuda

DATA = (b"abra cadabra abra cadabra! abracadabra? "
        b"the rain in spain falls mainly on the plain. " * 3)[:192]
C = 8
SITES = {"sweep": dict(u_lo=64, span=64), "byte": dict(span=len(DATA)),
         "packet": dict(span=None)}


@pytest.fixture(scope="module", params=[(0, 1), (0, 2), (3, 1), (3, 2)],
                ids=["lc0-p1", "lc0-p2", "lc3-p1", "lc3-p2"])
def setup(request):
    """(cfg, reference context, port context, {state name: reference
    state}): a fresh state (uniform probabilities: many tied metrics) and
    the state after three iterations."""
    lc, proposals = request.param
    cfg = JConfig(chains=C, max_candidates=8, max_walk=48, top_k=12,
                  iters_per_epoch=4, lc=lc, proposals=proposals,
                  init="greedy")
    jx = JE.make_context(DATA, cfg)
    tx = TE.context_from_numpy(
        data=np.asarray(jx.data), rank=np.asarray(jx.rank),
        sparse=np.asarray(jx.sparse), cand_dist=np.asarray(jx.cand_dist),
        cand_len=np.asarray(jx.cand_len),
        cand_count=np.asarray(jx.cand_count),
        init_slab=np.asarray(jx.init_slab), lc=lc, device="cpu")
    s0 = JE.init_state(jx, cfg)
    fresh = s0._replace(chains=s0.chains._replace(
        rank_probs=jnp.full_like(s0.chains.rank_probs, JT.PROB_INIT)))
    states = {"fresh": fresh, "iterated": JE.run_iters(s0, jx, cfg, 3)}
    return cfg, jx, tx, states


def _inputs(js, n):
    """The engine's per-chain ctx and rep stack (a chain whose recorded
    site ran off the end takes the snapshot's); sites at the block's last
    position, at 0, past the end, and in the repeating part of the block
    where the table has matches."""
    ch = js.chains
    fresh = np.asarray(ch.rec_live) >= n
    carry = np.asarray(ch.snap_carry)
    rec_ctx = np.where(fresh, carry[:, 0], np.asarray(ch.rec_ctx))
    rec_dists = np.where(fresh[:, None], carry[:, 1:5],
                         np.asarray(ch.rec_dists))
    q = np.random.default_rng(1673551).integers(85, n, C).astype(np.int32)
    q[:3] = n - 1, 0, n
    return q, rec_ctx.astype(np.int32), rec_dists.astype(np.int32)


def _reference(cfg, jx, js, q, rec_ctx, rec_dists, site):
    """The reference's proposal stage for the chains of `js`."""
    ch = js.chains
    n = jx.data.shape[0]
    Pn = cfg.proposals
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(ch.key)
    key_next, k_prop, k_u, k_acc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    skey_next = jax.random.split(js.skey, 2)[0]
    slab, probs, live = ch.slab, ch.rank_probs, ch.live_count
    q, rec_ctx, rec_dists = map(jnp.asarray, (q, rec_ctx, rec_dists))
    if Pn > 1:
        def split_rows(k):
            k = jax.vmap(lambda kk: jax.random.split(kk, Pn))(k)
            return k.reshape((C * Pn,) + k.shape[2:])
        k_prop, k_u = split_rows(k_prop), split_rows(k_u)
        slab, probs, live, q, rec_ctx, rec_dists = (
            jnp.repeat(x, Pn, axis=0)
            for x in (slab, probs, live, q, rec_ctx, rec_dists))
    cands = jax.vmap(lambda s, qq, rd: JM.enumerate_candidates(
        s, qq, rd, jx.data, jx.rank, jx.sparse, jx.cand_dist, jx.cand_len,
        jx.cand_count, sublens=cfg.sublens))(slab, q, rec_dists)
    qc = jnp.clip(q, 0, n - 1)
    candp = JP.pack(cands.ptype, cands.dist, cands.length,
                    cands.valid.astype(jnp.int32))
    mb = jx.data[jnp.clip(qc - rec_dists[:, 0] - 1, 0, n - 1)]
    prev = jnp.where(qc > 0, jx.data[jnp.maximum(qc - 1, 0)], 0)
    metric = pallas_rank.rank_pallas(
        probs, candp, rec_ctx, rec_dists, jx.data[qc], mb, jx.log2, jx.f2p,
        jx.corr, cb=C * Pn, interpret=True, prev_byte=prev, lc=cfg.lc)
    v0, v1 = jax.vmap(
        functools.partial(JM.select_mutation, top_k=cfg.top_k),
        in_axes=(0, 0, 0, 0, 0, 0, None))(slab, q, rec_dists, cands, metric,
                                          k_prop, jx.data)
    if site["span"] is None:
        u = jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h))(
            k_u, jnp.maximum(live, 1))
    else:
        u = site.get("u_lo", 0) + jax.vmap(
            lambda k: jax.random.randint(k, (), 0, site["span"]))(k_u)
    acc_u = jax.vmap(jax.random.uniform)(k_acc)
    return key_next, skey_next, v0, v1, u, acc_u, metric


def _port_args(cfg, tx, js, q, rec_ctx, rec_dists):
    st = TE.state_from_numpy(
        {"chains": {f: np.asarray(getattr(js.chains, f))
                    for f in js.chains._fields},
         **{f: np.asarray(getattr(js, f)) for f in js._fields
            if f != "chains"}}, "cpu")
    ch = st.chains
    args = (ch.key, st.skey, ch.slab, torch.as_tensor(q),
            torch.as_tensor(rec_ctx), torch.as_tensor(rec_dists),
            ch.rank_probs, ch.live_count, tx)
    kw = dict(proposals=cfg.proposals, top_k=cfg.top_k,
              sublens=cfg.sublens, lc=cfg.lc)
    return args, kw


NAMES = ("key_next", "skey_next", "v0", "v1", "u", "acc_u", "metric")


def _as_reference(name, t):
    """A port output in the reference's dtype (keys and cells as uint32
    words)."""
    a = t.numpy()
    if name in ("key_next", "skey_next", "v0", "v1"):
        return a.astype(np.int64).astype(np.uint32)
    return a


@pytest.mark.parametrize("state", ["fresh", "iterated"])
@pytest.mark.parametrize("site", list(SITES))
def test_propose_plain_matches_reference(setup, site, state):
    cfg, jx, tx, states = setup
    js = states[state]
    n = len(DATA)
    q, rec_ctx, rec_dists = _inputs(js, n)
    want = _reference(cfg, jx, js, q, rec_ctx, rec_dists, SITES[site])
    args, kw = _port_args(cfg, tx, js, q, rec_ctx, rec_dists)
    got = propose_cuda.propose_plain(*args, **kw, **SITES[site])
    rows = C * cfg.proposals
    assert got[6].shape == (rows, 2 + cfg.sublens * (4 + 8))
    for name, g, w in zip(NAMES, got, want):
        g = _as_reference(name, g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)
    metric = got[6].numpy()
    assert (metric < propose_cuda.BIG).sum() > 2 * rows  # real candidates
    if state == "fresh":          # uniform probabilities: tied candidates
        assert any(len(np.unique(m[m < propose_cuda.BIG]))
                   < (m < propose_cuda.BIG).sum() for m in metric)


def test_propose_dispatch_on_cpu(setup):
    """`propose` takes the plain version for CPU tensors; the kernel's
    wrapper refuses them rather than fall back."""
    cfg, jx, tx, states = setup
    js = states["iterated"]
    q, rec_ctx, rec_dists = _inputs(js, len(DATA))
    args, kw = _port_args(cfg, tx, js, q, rec_ctx, rec_dists)
    got = propose_cuda.propose(*args, **kw, span=len(DATA))
    want = propose_cuda.propose_plain(*args, **kw, span=len(DATA))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        propose_cuda.propose_cuda(*args, **kw, span=len(DATA))
