"""Candidate enumeration, ranking and the mutation choice of
megalania_tpu_torch equal megalania_tpu's: the plain ranking
(propose_cuda.rank_plain, behind moves.rank_candidates) against the Pallas
ranking kernel in interpret mode and the reference's XLA ranking."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from megalania_tpu.anneal import engine as JE, moves as JM
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.models import packets as JP
from megalania_tpu.ops import pallas_rank, pallas_repair2
from megalania_tpu_torch.anneal import engine as TE, moves as TM
from megalania_tpu_torch.models import packets as TP
from megalania_tpu_torch.ops import propose_cuda
from megalania_tpu_torch.utils import threefry as R

DATA = (b"abra cadabra abra cadabra! abracadabra? "
        b"the rain in spain falls mainly on the plain. " * 3)[:192]
C = 8


@pytest.fixture(scope="module", params=[0, 3], ids=["lc0", "lc3"])
def setup(request):
    lc = request.param
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48, lc=lc,
                       init="greedy")
    j = JE.make_context(DATA, cfg)
    t = TE.context_from_numpy(
        data=np.asarray(j.data), rank=np.asarray(j.rank),
        sparse=np.asarray(j.sparse), cand_dist=np.asarray(j.cand_dist),
        cand_len=np.asarray(j.cand_len), cand_count=np.asarray(j.cand_count),
        init_slab=np.asarray(j.init_slab), lc=lc, device="cpu")
    state = JE.init_state(j, cfg)
    rng = np.random.default_rng(1673551 + lc)
    n = len(DATA)
    slabs = np.asarray(state.chains.slab)
    q = rng.integers(0, n, C).astype(np.int32)
    q[0] = n - 1
    rec_ctx = rng.integers(0, 12, C).astype(np.int32)
    rec_dists = np.sort(rng.integers(0, n - 1, (C, 4)), axis=1).astype(
        np.int32)
    return lc, j, t, state, slabs, q, rec_ctx, rec_dists


def _tt(a):
    return torch.as_tensor(np.asarray(a))


def _cands(setup):
    lc, j, t, state, slabs, q, rec_ctx, rec_dists = setup
    jc = jax.vmap(lambda s, qq, rd: JM.enumerate_candidates(
        s, qq, rd, j.data, j.rank, j.sparse, j.cand_dist, j.cand_len,
        j.cand_count))(jnp.asarray(slabs), jnp.asarray(q),
                       jnp.asarray(rec_dists))
    tc = TM.enumerate_candidates(
        TP.from_u32(slabs), _tt(q), _tt(rec_dists), t.data, t.rank,
        t.sparse, t.cand_dist, t.cand_len, t.cand_count)
    return jc, tc


def test_enumerate_candidates(setup):
    jc, tc = _cands(setup)
    for name, a, b in zip(JM.Candidates._fields, jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert tc.valid.sum() > 2 * C              # real candidates, not just lits


def test_rank_plain_matches_kernel_and_xla(setup):
    lc, j, t, state, slabs, q, rec_ctx, rec_dists = setup
    jc, tc = _cands(setup)
    n = len(DATA)
    qc = np.clip(q, 0, n - 1)
    data = np.asarray(j.data)
    byte = data[qc]
    mb = data[np.clip(qc - rec_dists[:, 0] - 1, 0, n - 1)]
    prev = np.where(qc > 0, data[np.maximum(qc - 1, 0)], 0).astype(np.int32)
    probs = np.asarray(state.chains.rank_probs)

    got = TM.rank_candidates(tc, _tt(probs), _tt(rec_ctx), _tt(rec_dists),
                             _tt(byte), _tt(mb), _tt(prev), lc=lc).numpy()
    want_xla = jax.vmap(lambda c, rp, rc, rd, b, m, pv: JM.rank_candidates(
        c, rp, rc, rd, b, m, j.log2, j.f2p, prev_byte=pv, lc=lc))(
        jc, probs, rec_ctx, rec_dists, byte, mb, prev)
    np.testing.assert_array_equal(got, np.asarray(want_xla))
    corr = jnp.asarray(pallas_repair2.log2_correction(interpret=True))
    candp = JP.pack(jc.ptype, jc.dist, jc.length, jc.valid.astype(jnp.int32))
    want_kernel = pallas_rank.rank_pallas(
        jnp.asarray(probs), candp, jnp.asarray(rec_ctx),
        jnp.asarray(rec_dists), jnp.asarray(byte), jnp.asarray(mb), j.log2,
        j.f2p, corr, cb=C, interpret=True, prev_byte=jnp.asarray(prev),
        lc=lc)
    np.testing.assert_array_equal(got, np.asarray(want_kernel))
    # the proposal kernel's plain ranking, on the packed candidates
    np.testing.assert_array_equal(
        got, propose_cuda.rank_plain(_tt(probs), TM.pack_candidates(tc),
                                     _tt(rec_ctx), _tt(rec_dists), _tt(byte),
                                     _tt(mb), _tt(prev), lc=lc).numpy())
    assert (got < propose_cuda.BIG).sum() > C


def test_select_mutation(setup):
    """Boundary moves and the biased top-K draw: the two mutated cells
    equal the reference's for the same keys and metric (ties included:
    every invalid candidate ties at BIG)."""
    lc, j, t, state, slabs, q, rec_ctx, rec_dists = setup
    jc, tc = _cands(setup)
    rng = np.random.default_rng(7)
    metric = np.where(np.asarray(jc.valid),
                      rng.integers(0, 6, jc.valid.shape), 2**30).astype(
        np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    jv0, jv1 = jax.vmap(lambda s, qq, rd, c, m, k: JM.select_mutation(
        s, qq, rd, c, m, k, j.data, top_k=12))(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(rec_dists), jc,
        jnp.asarray(metric), keys)
    tv0, tv1 = TM.select_mutation(
        TP.from_u32(slabs), _tt(q), _tt(rec_dists), tc, _tt(metric),
        R.split(R.PRNGKey(11), C), t.data, top_k=12)
    np.testing.assert_array_equal(np.asarray(jv0), TP.to_u32(tv0))
    np.testing.assert_array_equal(np.asarray(jv1), TP.to_u32(tv1))
