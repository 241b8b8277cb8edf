#!/usr/bin/env python3
"""A/B of reference-semantics variants at matched move budgets, on
megalania_tpu_torch: site_mode byte-uniform against packet-uniform (the
reference's rule, packet_slab_neighbour.c:162-163) and the repair
fallback of an un-re-aimable long rep.

The port of tools/ab_semantics.py: the same variants, budget rule
(a fraction of the reference schedule, 3 x 200 x n moves, so the sweep
also runs on the CPU), chain_block rule, JSON line per (corpus,
variant) and winner summary.  The corpora are the pinned snapshots
tools/corpus/{survey.md,pallas.md,engine.py}, where ab_semantics.py
reads live files (SURVEY.md, the Pallas guide, the package's own
engine.py): engine.py here is the r3 snapshot, not today's file.

    python3 tools/ab_semantics_torch.py [--n 1024] [--budget-scale 0.125]
        [--chains 128] [--device {cuda,cpu}]

--device cuda (the default) fails without a card.  main() returns
{corpus: {variant: best_bytes}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from megalania_tpu_torch import cli  # noqa: E402
from megalania_tpu_torch.anneal import engine  # noqa: E402
from megalania_tpu_torch.anneal.config import AnnealConfig  # noqa: E402

CORPORA = [(name, os.path.join(TOOLS, "corpus", name))
           for name in ("survey.md", "pallas.md", "engine.py")]
VARIANTS = [
    {"site_mode": "byte"},
    {"site_mode": "packet"},
    {"lrep_fallback": "match"},
    {"site_mode": "packet", "lrep_fallback": "match"},
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--budget-scale", type=float, default=0.125)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)

    results, wins = {}, {}
    for name, path in CORPORA:
        with open(path, "rb") as f:
            data = f.read()[:args.n]
        n = len(data)
        budget = max(1, int(3 * 200 * n * args.budget_scale))
        iters = max(1, budget // args.chains)
        sizes = results[name] = {}
        for var in VARIANTS:
            cb = args.chains if args.chains % 128 == 0 else 128
            cfg = AnnealConfig(chains=args.chains, chain_block=cb, **var)
            ctx = engine.make_context(data, cfg, device)
            t0 = time.perf_counter()
            st = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg,
                                  iters)
            key = json.dumps(var, sort_keys=True)
            sizes[key] = engine.best_cost_bytes(st)   # waits for the device
            print(json.dumps({
                "corpus": name, "n": n, "moves": iters * args.chains,
                **var, "best_bytes": sizes[key],
                "seconds": time.perf_counter() - t0}), flush=True)
        best = min(sizes, key=sizes.get)
        wins[best] = wins.get(best, 0) + 1
        print(f"# {name}: winner {best}", flush=True)
    print("WINS:", json.dumps(wins), flush=True)
    return results


if __name__ == "__main__":
    main()
