"""The slice as a whole: megalania_tpu_torch's engine on the CPU (plain
versions) against megalania_tpu — the block context, the initial state
and the full AnnealState after 12 iterations (restarts included), all
identical.  tests/test_torch_compress.py covers the bytes and the CLI."""
import os

import numpy as np
import pytest

from megalania_tpu.anneal import engine as JE
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig
from megalania_tpu_torch.models import packets as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBC = open(os.path.join(ROOT, "tools", "corpus", "libc.so"), "rb").read()
DATA = LIBC[4096:4096 + 256]
BASE = dict(chains=8, max_candidates=8, max_walk=48, top_k=12,
            iters_per_epoch=4)
CONFIGS = {
    "defaults": {},
    "branches": dict(site_mode="packet", proposals=2, accept="mixed",
                     init="mixed_opt", lrep_fallback="litsrep"),
}


def _state_equal(js, ts):
    t = TE.state_to_numpy(ts)
    for f in js.chains._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js.chains, f)),
                                      t["chains"][f], err_msg=f"chains.{f}")
    for f in js._fields:
        if f != "chains":
            np.testing.assert_array_equal(np.asarray(getattr(js, f)), t[f],
                                          err_msg=f)


@pytest.fixture(scope="module", params=list(CONFIGS))
def both(request):
    kw = dict(BASE, **CONFIGS[request.param])
    jc, tc = JConfig(**kw), TConfig(**kw)
    return jc, tc, JE.make_context(DATA, jc), TE.make_context(DATA, tc,
                                                              "cpu")


def test_make_context(both):
    jc, tc, jx, tx = both
    for f in ("data", "rank", "sparse", "cand_dist", "cand_len",
              "cand_count", "log2", "f2p"):
        np.testing.assert_array_equal(np.asarray(getattr(jx, f)),
                                      getattr(tx, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jx.init_slab),
                                  TP.to_u32(tx.init_slab))
    assert tx.device.type == "cpu" and tx.corr.shape == (128,)


def test_init_state(both):
    jc, tc, jx, tx = both
    _state_equal(JE.init_state(jx, jc), TE.init_state(tx, tc))


def test_state_after_12_iterations(both):
    jc, tc, jx, tx = both
    js = JE.run_iters(JE.init_state(jx, jc), jx, jc, 12)
    ts = TE.run_iters(TE.init_state(tx, tc), tx, tc, 12)
    assert ts.epochs_done == 3                       # restarts happened
    _state_equal(js, ts)
    # a state carried across packages continues identically
    back = TE.state_from_numpy(TE.state_to_numpy(ts), "cpu")
    _state_equal(JE.run_iters(js, jx, jc, 1), TE.run_iters(back, tx, tc, 1))
