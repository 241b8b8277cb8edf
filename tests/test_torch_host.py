"""Host-side pieces of megalania_tpu_torch against megalania_tpu: packet
packing, bit plans and exact costs, the emission op stream and bytes,
and the rule that the port never imports jax."""
import lzma
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from megalania_tpu.models import packets as JP
from megalania_tpu.ops import bitplan as JB, emit_plan as JEP
from megalania_tpu.ops import problayout as JPL, tables as JT
from megalania_tpu.runtime import emit as JEM
from megalania_tpu_torch.models import packets as TP
from megalania_tpu_torch.ops import bitplan as TB, emit_plan as TEP
from megalania_tpu_torch.ops import problayout as TPL
from megalania_tpu_torch.runtime import emit as TEM, pyemit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(os.path.join(ROOT, "tools", "corpus", f)
                for f in os.listdir(os.path.join(ROOT, "tools", "corpus")))


def _random_fields(rng, k):
    return (rng.integers(0, 4, k), rng.integers(0, 1 << 20, k),
            rng.integers(0, 512, k), rng.integers(0, 2, k))


def test_pack_unpack_every_field(rng):
    t, d, ln, live = _random_fields(rng, 4096)
    want = JP.pack_np(t, d, ln, live)
    got = TP.pack(torch.as_tensor(t), torch.as_tensor(d),
                  torch.as_tensor(ln), torch.as_tensor(live))
    np.testing.assert_array_equal(TP.to_u32(got), want)
    np.testing.assert_array_equal(
        TP.to_u32(got), np.asarray(JP.pack(t, d, ln, live)))
    for g, w in zip(TP.unpack(TP.from_u32(want)), JP.unpack_np(want)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (TP.unpack(TP.from_u32(want))[3].numpy() == live).all()
    assert TP.from_u32(want).dtype == torch.int32


def _random_states(rng, k, n=1 << 19):
    """Random packets with plausible coder states (all types, rep
    indices 0..3, lengths 1..273, distances across every pos slot)."""
    t = rng.integers(0, 4, k)
    d = np.where(t == JP.LREP, rng.integers(0, 4, k),
                 rng.integers(0, n, k) >> rng.integers(0, 19, k))
    ln = np.where(t >= 1, rng.integers(2, 274, k), 1)
    ctx = rng.integers(0, 12, k)
    dists = rng.integers(0, n, (k, 4))
    byte, mb, prev = (rng.integers(0, 256, k) for _ in range(3))
    return [np.asarray(a, np.int32) for a in
            (t, d, ln, ctx, dists, byte, mb, prev)]


@pytest.mark.parametrize("lc", [0, 1, 2, 3, 4])
def test_bit_plan_cost_and_adaptation(rng, lc):
    t, d, ln, ctx, dists, byte, mb, prev = _random_states(rng, 512)
    jplan = jax.vmap(lambda *a: JB.make_bit_plan(*a[:7], prev_byte=a[7],
                                                 lc=lc))(
        t, d, ln, ctx, dists, byte, mb, prev)
    tt = [torch.as_tensor(a) for a in (t, d, ln, ctx, dists, byte, mb, prev)]
    tplan = TB.make_bit_plan(*tt[:7], prev_byte=tt[7], lc=lc)
    for name, j, g in zip(JB.BitPlan._fields, jplan, tplan):
        np.testing.assert_array_equal(np.asarray(j), g.numpy(),
                                      err_msg=name)

    # trained probabilities: the reference oracle encoder over a block
    data = open(CORPUS[0], "rb").read()[:1024]
    enc = pyemit.Encoder(data, pyemit.CostSink(), lc=lc)
    for _, pt, pd, pl in pyemit.walk_slab(JP.literal_slab(len(data))):
        enc.encode_packet(pt, pd, pl)
    probs = np.broadcast_to(enc.probs, (512, enc.probs.shape[0])).copy()
    log2 = JT.LOG2_TABLE_I32
    jcost = jax.vmap(lambda p, pl: JB.plan_cost(p, pl, jnp.asarray(log2),
                                                lc=lc))(probs, jplan)
    tcost = TB.plan_cost(torch.as_tensor(probs), tplan,
                         torch.as_tensor(log2), lc=lc)
    np.testing.assert_array_equal(np.asarray(jcost), tcost.numpy())

    lay = JPL.get_layout(lc)
    packed = np.array(lay.packed_from_flat(jnp.asarray(probs)))
    np.testing.assert_array_equal(
        TPL.get_layout(lc).packed_from_flat(torch.as_tensor(probs)).numpy(),
        packed)
    tpc = TB.plan_cost_packed(torch.as_tensor(packed), tplan,
                              torch.as_tensor(log2),
                              torch.as_tensor(lay.F2P_PAD), lc=lc)
    np.testing.assert_array_equal(np.asarray(jcost), tpc.numpy())

    japp = jax.vmap(lambda p, pl: JB.apply_plan(p, pl, jnp.asarray(log2),
                                                lc=lc))(probs, jplan)
    tprobs = torch.as_tensor(probs.copy())
    tapp = TB.apply_plan(tprobs, tplan, torch.as_tensor(log2), lc=lc)
    np.testing.assert_array_equal(np.asarray(japp[1]), tapp.numpy())
    np.testing.assert_array_equal(np.asarray(japp[0]), tprobs.numpy())


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_emit_plan_and_bytes(path):
    """2 KiB slices of every corpus file, parsed by the reference's
    optimum seed: the port's op stream equals the reference's at every
    live position, and both emit the same decodable bytes."""
    from megalania_tpu.anneal.config import AnnealConfig
    from megalania_tpu.match import optparse

    data = open(path, "rb").read()[:2048]
    slab, _ = optparse.seed_slab(np.frombuffer(data, np.uint8),
                                 AnnealConfig())
    for lc in (0, 3):
        jout = [np.asarray(a) for a in JEP.emit_plan_jit(
            jnp.asarray(slab), jnp.asarray(
                np.frombuffer(data, np.uint8).astype(np.int32)), lc=lc)]
        pos, *tout = TEP.emit_plan(slab, data, lc=lc)
        live = np.zeros(len(data), bool)
        live[pos] = True
        assert not jout[2][~live].any()          # no ops off live packets
        for name, j, t in zip(("idx", "bit", "active", "n_direct",
                               "direct_val"), jout, tout):
            np.testing.assert_array_equal(j[pos], t, err_msg=name)
        blob = TEM.emit(data, slab, lc=lc)
        assert blob == JEM.emit(data, slab, lc=lc)
        assert blob == pyemit.emit(data, slab, lc=lc)
        assert lzma.decompress(blob, format=lzma.FORMAT_ALONE) == data


def test_lce_every_pair():
    """match/suffix.lce against the reference's lce_jnp over every pair
    (a, b) of a block, a == b included: at a == b with the last rank the
    query reaches one column past the sparse table, which the reference's
    gather clamps (a 128-byte libc.so cut, whose position 0 has it)."""
    from megalania_tpu.match import suffix as JS
    from megalania_tpu_torch.match import suffix as TS
    with open(os.path.join(ROOT, "tools", "corpus", "libc.so"), "rb") as f:
        data = f.read()[:128]
    n = len(data)
    idx = TS.build_lce(data)
    jidx = JS.build_lce(data)
    assert idx.rank[0] == n - 1
    np.testing.assert_array_equal(idx.rank, jidx.rank)
    a, b = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    want = JS.lce_jnp(jnp.asarray(jidx.rank), jnp.asarray(jidx.sparse), n,
                      jnp.asarray(a), jnp.asarray(b))
    got = TS.lce(torch.as_tensor(idx.rank), torch.as_tensor(idx.sparse), n,
                 torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_never_imports_jax():
    """Every megalania_tpu_torch module imports without pulling in jax
    (a subprocess: this test process has jax loaded already)."""
    code = r"""
import importlib, pkgutil, sys
import megalania_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 20, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("ok", len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
