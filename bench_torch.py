#!/usr/bin/env python3
"""Benchmark of megalania_tpu_torch: anneal moves/s on one card against
the reference C implementation.

The port of bench.py.  Baseline (BASELINE.md): the reference does 16.9k
moves/s at n=2000 on one x86 core, where one move is one full-parse
re-cost.  The unit of work here is the same: one exact re-cost + repair
per chain per iteration, C chains at once on one card.

Rows, settings and rules are bench.py's:
  * n=2048: SURVEY.md's bytes (tools/corpus/survey.md, the same file),
    BENCH_CHAINS chains (512), init=mixed, accept=cooled, BENCH_ITERS
    (512) warm-up iterations and then as many timed ones;
  * n=65536, the design point: the same bytes repeated to n,
    BENCH_CHAINS_64K chains (512), BENCH_ITERS_64K iterations (0 = one
    sweep cycle), once with init=mixed and once with init=optimal (the
    converged rate).  Its baseline is 16.9k x 2000/65536 ~= 515.8
    moves/s (the reference's per-move cost is linear in n).
The warm-up and the timed window continue one state, so the best
printed is the one after 2 x iters iterations.  chain_block is the
widest of 512/384/256/128 that divides the chains (512 at 512 chains):
it sets the sweep tile and so the trajectory.  BENCH_PROPOSALS sets the
proposals per chain, BENCH_SKIP_64K=1 skips the design point.
bench.py's BENCH_KERNEL and BENCH_RANKER pick TPU kernel paths that the
port does not have; they are not read.  A failing row raises: the
script then exits non-zero (bench.py instead notes a failed design-point
row on stderr and prints the rest).

    python3 bench_torch.py [--device {cuda,cpu}]

--device cuda (the default) fails without a card; the timed window lies
between two torch.cuda.synchronize() calls.  Prints ONE JSON line with
bench.py's keys, each row's best (bytes and the exact integer cost in
1/16384 bit), and on the card its name and power limit as nvidia-smi
gives them; a line per row goes to stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from megalania_tpu_torch import cli  # noqa: E402
from megalania_tpu_torch.anneal import engine  # noqa: E402
from megalania_tpu_torch.anneal.config import AnnealConfig  # noqa: E402
from megalania_tpu_torch.utils import fixedpoint as fp  # noqa: E402

N = 2048                 # the reference's measured n=2000 scale
BASELINE_MOVES_PER_S = 16900.0   # reference @ n=2000 (BASELINE.md)
N64K = 1 << 16
BASELINE_64K = BASELINE_MOVES_PER_S * 2000.0 / N64K   # ~515.8 moves/s
DATA = os.path.join(ROOT, "tools", "corpus", "survey.md")


def chain_block(chains: int, cb_cap: int = 512) -> int:
    """bench.py's rule: the widest of cb_cap/384/256/128 (at most cb_cap)
    that divides the chains, else 128."""
    if chains % 128:
        return 128
    return max(d for d in (cb_cap, 384, 256, 128)
               if d <= cb_cap and chains % d == 0)


def corpus(n: int, data_path: str = DATA) -> bytes:
    """The bytes of `data_path` repeated to n and cut."""
    with open(data_path, "rb") as f:
        data = f.read()
    return (data * (n // len(data) + 1))[:n]


def _sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def measure(n: int, chains: int, iters: int, data_path: str = DATA,
            cb_cap: int = 512, init: str | None = None,
            device: str = "cuda") -> dict:
    """One row: `iters` warm-up iterations, then `iters` timed ones from
    the state they left (iters == 0: one sweep cycle each).  Returns
    moves_per_s, seconds (the timed window), best_bytes, best_cost (the
    exact integer behind best_bytes), iters and moves."""
    device = cli.require_device(device)
    data = corpus(n, data_path)
    # init="mixed" and accept="cooled" pin the rows bench.py measured;
    # the converged row passes init="optimal"
    cfg = AnnealConfig(
        chains=chains, chain_block=chain_block(chains, cb_cap),
        proposals=int(os.environ.get("BENCH_PROPOSALS", "1")),
        init="mixed" if init is None else init, accept="cooled")
    if iters == 0:    # one full sweep cycle: n_tiles x sweep_repeats
        tile = engine.choose_tile(n, cfg.chain_block, cfg.lc)
        iters = (-(-n // tile)) * cfg.sweep_repeats
    ctx = engine.make_context(data, cfg, device)
    state = engine.init_state(ctx, cfg)
    # the warm-up has the timed run's shape; a real run is 600n moves,
    # so the first iterations are start-up
    state = engine.run_iters(state, ctx, cfg, iters)
    _sync(device)
    t0 = time.perf_counter()
    state = engine.run_iters(state, ctx, cfg, iters)
    _sync(device)
    dt = time.perf_counter() - t0
    moves = chains * iters * cfg.proposals
    return {"moves_per_s": moves / dt, "seconds": dt,
            "best_bytes": engine.best_cost_bytes(state),
            "best_cost": fp.to_int(state.best_hi, state.best_lo),
            "iters": iters, "moves": moves}


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)
    chains = int(os.environ.get("BENCH_CHAINS", "512"))
    chains64 = int(os.environ.get("BENCH_CHAINS_64K", "512"))
    iters = int(os.environ.get("BENCH_ITERS", "512"))
    iters64 = int(os.environ.get("BENCH_ITERS_64K", "0"))   # 0 = one sweep

    rows = [("n=%d chains=%d" % (N, chains),
             measure(N, chains, iters, device=device))]
    out = {
        "metric": "anneal_moves_per_sec_per_chip",
        "value": rows[0][1]["moves_per_s"],
        "unit": "moves/s",
        "vs_baseline": rows[0][1]["moves_per_s"] / BASELINE_MOVES_PER_S,
        "best_bytes": rows[0][1]["best_bytes"],
        "best_cost": rows[0][1]["best_cost"],
    }
    if os.environ.get("BENCH_SKIP_64K", "0") != "1":
        mixed = measure(N64K, chains64, iters64, device=device)
        conv = measure(N64K, chains64, iters64, init="optimal",
                       device=device)
        rows += [("n=%d chains=%d (design point)" % (N64K, chains64), mixed),
                 ("n=%d chains=%d (design point, converged)"
                  % (N64K, chains64), conv)]
        out["design_point_n65536"] = {
            "moves_per_s": mixed["moves_per_s"],
            "vs_baseline": mixed["moves_per_s"] / BASELINE_64K,
            "converged_moves_per_s": conv["moves_per_s"],
            "converged_vs_baseline": conv["moves_per_s"] / BASELINE_64K,
            "best_bytes": mixed["best_bytes"],
            "best_cost": mixed["best_cost"],
            "converged_best_bytes": conv["best_bytes"],
            "converged_best_cost": conv["best_cost"],
        }
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = smi()
    else:
        out["device"] = "cpu"
    print(json.dumps(out), flush=True)
    for head, r in rows:
        sys.stderr.write("%s iters=%d dt=%.2fs best=%.2fB device=%s\n" % (
            head, r["iters"], r["seconds"], r["best_bytes"], device))
    return out


if __name__ == "__main__":
    main()
