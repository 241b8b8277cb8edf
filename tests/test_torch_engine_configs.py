"""Whole-engine parity for the configurations test_torch_engine.py does
not run: megalania_tpu_torch's engine on the CPU against megalania_tpu,
the full AnnealState after 12 iterations, identical.  The cases are lc=3,
greedy acceptance, the random site schedule, the greedy and literal
initial parses, and a 2,048-byte block (8 sweep tiles) whose sweep
advances past stratum 0.  Last, engine.choose_tile against the
reference's over a grid of block sizes, chain blocks and lc, since the
tile sets the sweep strata and so the trajectory."""
import pytest

from megalania_tpu.anneal import engine as JE
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu.ops import pallas_repair2
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig

from test_torch_engine import BASE, DATA, LIBC, _state_equal

CASES = {
    "lc3": (DATA, dict(BASE, lc=3)),
    "accept_greedy": (DATA, dict(BASE, accept="greedy")),
    "site_schedule_random": (DATA, dict(BASE, site_schedule="random")),
    "init_greedy": (DATA, dict(BASE, init="greedy")),
    "init_literal": (DATA, dict(BASE, init="literal")),
    # the default epoch length (no restart within 12 iterations), so the
    # sweep walks strata 0, 1 and 2 of the 256-position tiles
    "n2048_sweep": (LIBC[4096:4096 + 2048], dict(BASE, iters_per_epoch=None)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_state_after_12_iterations(case):
    data, kw = CASES[case]
    jc, tc = JConfig(**kw), TConfig(**kw)
    jx, tx = JE.make_context(data, jc), TE.make_context(data, tc, "cpu")
    js = JE.run_iters(JE.init_state(jx, jc), jx, jc, 12)
    ts = TE.run_iters(TE.init_state(tx, tc), tx, tc, 12)
    _state_equal(js, ts)
    if case == "n2048_sweep":
        tile = TE.choose_tile(len(data), tc.chain_block, tc.lc)
        assert tile == 256 and ts.epochs_done == 0
        assert ts.sweep_j == 12 and ts.u_prev == 2 * tile   # strata 0-2
        assert int(ts.snap_pos) > 0            # a snapshot above position 0
    else:
        assert ts.epochs_done == 3             # restarts happened


@pytest.mark.parametrize("lc", range(5))
@pytest.mark.parametrize("n", [256, 2048, 65536, 1 << 20])
def test_choose_tile(monkeypatch, n, lc):
    monkeypatch.delenv("MEGALANIA_TILE", raising=False)
    monkeypatch.delenv("MEGALANIA_VMEM_BUDGET_MB", raising=False)
    cbs = (128, 256, 384, 512)
    assert ([TE.choose_tile(n, cb, lc) for cb in cbs]
            == [pallas_repair2.choose_tile(n, cb, lc) for cb in cbs])
