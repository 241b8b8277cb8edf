"""The port's plain repair pass (megalania_tpu_torch/ops/repair_scan.py,
behind repair_cuda.repair_cost_plain) equals megalania_tpu's golden scan
and its Pallas kernel in interpret mode, integer for integer, on the
inputs tests/test_pallas_repair.py uses (n = 192, C = 8)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from megalania_tpu.anneal import engine as JE
from megalania_tpu.anneal.config import AnnealConfig
from megalania_tpu.models import packets as JP
from megalania_tpu.ops import pallas_repair2, repair_scan as JR
from megalania_tpu.ops import problayout as JPL
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.models import packets as TP
from megalania_tpu_torch.ops import log2_cuda, repair_cuda, tables as TT

DATA = (b"abra cadabra abra cadabra! abracadabra? "
        b"the rain in spain falls mainly on the plain. " * 3)[:192]
C = 8
NAMES = ("slab", "hi", "lo", "probs", "rec_ctx", "rec_dists", "rec_live",
         "live_count", "snap_carry")


@pytest.fixture(scope="module")
def ctxs():
    cfg = AnnealConfig(chains=C, max_candidates=8, max_walk=48)
    j = JE.make_context(DATA, cfg)
    t = TE.context_from_numpy(
        data=np.asarray(j.data), rank=np.asarray(j.rank),
        sparse=np.asarray(j.sparse), cand_dist=np.asarray(j.cand_dist),
        cand_len=np.asarray(j.cand_len), cand_count=np.asarray(j.cand_count),
        init_slab=np.asarray(j.init_slab), device="cpu")
    corr = jnp.asarray(pallas_repair2.log2_correction(interpret=True))
    return j, t, corr


def _mutated(ctx, rng):
    n = ctx.data.shape[0]
    slabs = np.broadcast_to(JP.literal_slab(n), (C, n)).copy()
    cd, cl = np.asarray(ctx.cand_dist), np.asarray(ctx.cand_len)
    for c in range(C):
        for _ in range(6):
            i = int(rng.integers(2, n - 4))
            m = int(rng.integers(0, cd.shape[1]))
            if cl[i, m] >= 2:
                slabs[c, i] = JP.pack_np(JP.MATCH, cd[i, m],
                                         min(int(cl[i, m]), n - i))
            slabs[c, int(rng.integers(1, n))] = JP.pack_np(
                JP.LREP, int(rng.integers(0, 4)), 2)
            slabs[c, int(rng.integers(1, n))] = JP.pack_np(JP.SREP, 0, 1)
    q = rng.integers(0, n // 2, C).astype(np.int32)
    u = rng.integers(0, n, C).astype(np.int32)
    return slabs, q, u


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _port(t, slabs, q, u, lc=0, probs_in=None, carry_in=None, **kw):
    return repair_cuda.repair_cost_plain(
        TP.from_u32(slabs), _i32(q), _i32(u), t.data, t.cand_dist,
        t.cand_len, t.log2, lc=lc,
        probs_in=None if probs_in is None else _i32(probs_in),
        carry_in=None if carry_in is None else _i32(carry_in), **kw)


def _np(out):
    out = [o.numpy() for o in out]
    out[0] = out[0].view(np.uint32)
    return out


def _assert_same(got, want, lc=0, flat_probs=False):
    want = [np.asarray(w) for w in want]
    if flat_probs:                 # the golden scan returns flat probs
        want[3] = np.asarray(JPL.get_layout(lc).packed_from_flat(
            jnp.asarray(want[3])))
    for name, g, w in zip(NAMES, _np(got), want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kw", [{}, {"lrep_fallback": "match"}, {"lc": 3}],
                         ids=["full_walk", "match_fallback", "lc3"])
def test_plain_repair_matches_scan_and_kernel(ctxs, rng, kw):
    j, t, corr = ctxs
    slabs, q, u = _mutated(j, rng)
    lc = kw.get("lc", 0)
    got = _port(t, slabs, q, u, **kw)
    want_scan = JR.repair_cost_batched(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.cand_dist, j.cand_len, j.log2, **kw)
    _assert_same(got, want_scan, lc=lc, flat_probs=True)
    want_kernel = pallas_repair2.repair_cost_pallas2(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.data_packed, j.cand_dist, j.cand_len, corr, cb=C, interpret=True,
        **kw)
    _assert_same(got, want_kernel, lc=lc)
    if "lrep_fallback" in kw:      # the variant must fire on this input
        base = _port(t, slabs, q, u)
        assert not np.array_equal(_np(got)[0], _np(base)[0])


def test_plain_repair_packet_sites(ctxs, rng):
    j, t, corr = ctxs
    slabs, q, _ = _mutated(j, rng)
    u = rng.integers(0, 64, C).astype(np.int32)       # packet ordinals
    got = _port(t, slabs, q, u, site_mode="packet")
    _assert_same(got, JR.repair_cost_batched(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.cand_dist, j.cand_len, j.log2, site_mode="packet"),
        flat_probs=True)
    _assert_same(got, pallas_repair2.repair_cost_pallas2.__wrapped__(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.data_packed, j.cand_dist, j.cand_len, corr, cb=C, interpret=True,
        site_mode="packet"))
    assert got[7].min() > 0


def test_plain_repair_substitution(ctxs, rng):
    """In-pass substitution of the two mutated cells == the reference
    kernel's in-stream substitution == scatter then the golden scan,
    including q == n-1."""
    j, t, corr = ctxs
    n = len(DATA)
    slabs, q, u = _mutated(j, rng)
    q[0] = n - 1
    mut0 = JP.pack_np(JP.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))
    mut1 = JP.pack_np(JP.LREP, rng.integers(0, 4, C), np.full(C, 2))
    got = _port(t, slabs, q, u, mut0=TP.from_u32(mut0),
                mut1=TP.from_u32(mut1))
    _assert_same(got, pallas_repair2.repair_cost_pallas2(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.data_packed, j.cand_dist, j.cand_len, corr, cb=C, interpret=True,
        mut0=jnp.asarray(mut0), mut1=jnp.asarray(mut1)))
    qc = np.clip(q, 0, n - 1)
    scattered = slabs.copy()
    scattered[np.arange(C), qc] = mut0
    nxt = qc + 1 < n
    scattered[np.arange(C)[nxt], qc[nxt] + 1] = mut1[nxt]
    _assert_same(got, JR.repair_cost_batched(
        jnp.asarray(scattered), jnp.asarray(q), jnp.asarray(u), j.data,
        j.cand_dist, j.cand_len, j.log2), flat_probs=True)


def test_plain_repair_partial_recost(ctxs, rng, monkeypatch):
    """A small tile (MEGALANIA_TILE=64): capture entering position 64,
    then a pass that starts from that snapshot — equal to the reference
    kernel's start/cap tiles and to the golden scan's start/cap
    positions, and to a full walk."""
    monkeypatch.setenv("MEGALANIA_TILE", "64")
    j, t, corr = ctxs
    n = len(DATA)
    assert pallas_repair2.choose_tile(n) == TE.choose_tile(n) == 64
    fn = pallas_repair2.repair_cost_pallas2.__wrapped__   # tile is traced
    slabs, q, u = _mutated(j, rng)
    p1 = _port(t, slabs, q, u, cap_pos=64)
    _assert_same(p1, fn(jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u),
                        j.data, j.data_packed, j.cand_dist, j.cand_len, corr,
                        cb=C, interpret=True, cap_tile=jnp.int32(1)))
    _assert_same(p1, JR.repair_cost_batched(
        jnp.asarray(slabs), jnp.asarray(q), jnp.asarray(u), j.data,
        j.cand_dist, j.cand_len, j.log2, cap_pos=jnp.int32(64)),
        flat_probs=True)

    slab1 = _np(p1)[0]
    probs1, carry1 = p1[3].numpy(), p1[8].numpy()
    q2 = rng.integers(128, n, C).astype(np.int32)
    u2 = rng.integers(64, n, C).astype(np.int32)
    part = _port(t, slab1, q2, u2, start_pos=64, probs_in=probs1,
                 carry_in=carry1)
    _assert_same(part, fn(jnp.asarray(slab1), jnp.asarray(q2),
                          jnp.asarray(u2), j.data, j.data_packed,
                          j.cand_dist, j.cand_len, corr, cb=C,
                          interpret=True, start_tile=jnp.int32(1),
                          probs_in=jnp.asarray(probs1),
                          carry_in=jnp.asarray(carry1)))
    full = _port(t, slab1, q2, u2)
    for name, g, w in zip(NAMES, _np(part), _np(full)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_correction_makes_float32_exact():
    """Fed a float32 probe computed on the CPU (the reference's own
    float32 sequence), the port's build_correction gives the
    reference's correction words, and raw + correction is the exact
    table for every p in 1..2047."""
    raw = np.asarray(pallas_repair2._f32_log2_cost(
        jnp.maximum(jnp.arange(2048, dtype=jnp.int32), 1)))
    corr = log2_cuda.build_correction(raw)
    np.testing.assert_array_equal(
        corr, np.asarray(pallas_repair2.log2_correction(interpret=True))[0])
    exact = log2_cuda.apply_correction(raw, corr)
    np.testing.assert_array_equal(exact[1:], TT.LOG2_TABLE_NP[1:])
    # numpy's float32 log2 is another float32 path; still exact after
    x = np.maximum(np.arange(2048), 1).astype(np.float32) * np.float32(
        1 / 2048)
    raw_np = np.trunc(-np.log2(x) * np.float32(2048)).astype(np.int32)
    exact = log2_cuda.apply_correction(raw_np,
                                       log2_cuda.build_correction(raw_np))
    np.testing.assert_array_equal(exact[1:], TT.LOG2_TABLE_NP[1:])
    # the plain probe is the table itself: an all-zero correction
    plain = log2_cuda.log2_probe_plain("cpu").numpy()
    assert (log2_cuda.build_correction(plain) == 0x55555555).all()
