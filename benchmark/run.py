#!/usr/bin/env python3
"""The benchmark of megalania_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads BENCHMARK.json at the root of the checkout, the cell's
configuration (configs/<config>.json) and traffic mix
(traffic/<traffic>.json), sets up, measures for S seconds, checks the
outputs against the plain reference (benchlib/reference.py) and prints
one JSON line last on standard output: the end-to-end metrics with
--trace 0, the per-layer metrics (metrics/<name>.py) with --trace 1.
The numbers compared, each with its limit, are the last lines on
standard error and the last key of the line.

A cell of several chips runs one process a card (benchlib/runner.py);
if one of them fails, or they outrun their deadline, all are killed.

Fails, printing no result, without a CUDA card (or with fewer than the
cell asks for), outside a checkout that holds megalania_tpu_torch, when
a rank of a cell of several chips fails, and if the JAX stack or the
JAX package is loaded once the window has closed, in this process or in
a rank's.  Build and kernel caches stay inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, "_bench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, BENCH)
    from benchlib import runner, spec as S
    spec = S.load(ROOT)
    wl = S.by_name(spec["workloads"], args.workload)
    conf = S.config(spec, wl["config"], ROOT)
    mix = S.traffic(wl["traffic"])

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"run.py: {wl['name']} needs {wl['chips']} CUDA card(s); "
              "found none or fewer", file=sys.stderr)
        return 2
    if not os.path.isfile(os.path.join(ROOT, "megalania_tpu_torch",
                                       "__init__.py")):
        print("run.py: no megalania_tpu_torch in this checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(1, ROOT)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"

    # a run that is ended kills its ranks on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        result, jax = runner.run_cell(spec, wl, conf, mix, args.seed,
                                      args.seconds, bool(args.trace),
                                      T_START)
    except runner.RankFailure as e:
        print(f"run.py: {wl['name']}: {e}", file=sys.stderr)
        return 4
    if jax:
        print(f"run.py: loaded after the window: {', '.join(jax)}",
              file=sys.stderr)
        return 3
    from benchlib import check
    checks = {k: v["value"] for k, v in result["checks"].items()}
    for line in check.lines(checks):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
