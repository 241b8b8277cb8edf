#!/usr/bin/env python3
"""The control of `correct` and the planted faults, read on the card.

For each seed a cell is set up and run at its own sizes for a short
window, as run.py runs it.  The control: the engine's exact costs of the
streams it emitted are replaced by the reference's costs summed in
float32 (one precision below the configuration's exact integer cost, a
sequential float32 accumulator as a device loop would keep it), and the
same comparison is made.  Each fault named (benchlib/faults.py) is then
planted and the cell run again on the same seed.  Prints one JSON line
per seed, with the numbers compared of the program, the control and each
fault, and last a summary: for each number the program's largest
reading (the lower one) and the smallest of the control and of each
fault (the upper ones).

    python3 benchmark/control.py --workload NAME --seconds S \\
        [--faults chains_stuck,half_chains@2] SEED...

A fault written `name@r` is planted in rank r only, in a cell of several
chips (benchlib/runner.py runs it one process a card).

Not part of a benchmark run; benchmark/tests/test_bench_control.py and
test_bench_faults.py make the same comparisons at sizes a CPU test
holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import torch
    from benchlib import check, reference, runner, spec as S
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    spec = S.load(ROOT)
    wl = S.by_name(spec["workloads"], args.workload)
    conf = S.config(spec, wl["config"], ROOT)
    mix = S.traffic(wl["traffic"])
    plants = [f for f in args.faults.split(",") if f]

    def plant(f):
        name, _, rank = f.partition("@")
        return [name, [int(rank)] if rank else None]
    lower, upper = {}, {"control": {}, **{f: {} for f in plants}}

    def keep(into, checks, pick):
        for k, v in checks.items():
            if k in check.LIMITS:
                into[k] = pick(into.get(k, v), v)

    for seed in args.seeds:
        payload = {"conf": conf, "mix": mix, "seed": seed,
                   "seconds": args.seconds, "trace": False,
                   "device_type": "cuda"}
        t0 = time.time()
        part = runner.parts_of(spec, wl, payload)
        checks = part["checks"]
        blocks, outs, _costs = part["judged"]
        f32 = [reference.decode(o, f32=True).cost for o in outs]
        control = check.streams(blocks, outs, f32)
        line = {"seed": seed, "correct": check.verdict(checks),
                "program": checks, "control": control,
                "control_correct": check.verdict(control)}
        keep(lower, checks, max)
        keep(upper["control"], control, min)
        for f in plants:
            try:
                fc = runner.parts_of(spec, wl, dict(
                    payload, plants=[plant(f)]))["checks"]
            except runner.RankFailure as e:
                fc = {"rank_failure": str(e)}
            line[f] = fc
            line[f + "_correct"] = check.verdict(fc) and "rank_failure" \
                not in fc
            keep(upper[f], fc, min)
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": wl["name"], "seeds": len(args.seeds),
                      "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
