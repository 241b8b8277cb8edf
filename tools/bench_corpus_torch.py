#!/usr/bin/env python3
"""Corpus benchmark of megalania_tpu_torch: the port against liblzma's
preset 9 | extreme and the reference binary's recorded sizes, at the
reference's move budget.

The port of tools/bench_corpus.py.  For each corpus member, cut to each
size n, the port runs the reference's total move count (3 steps x 200
epochs x n moves, its main.c:66-69) through compressor.compress on
--device, after one discarded warm-up run of one move per chain.  Each
output is decoded with Python's lzma (FORMAT_ALONE) and must give its
input back.  The xz9e column is liblzma's own preset 9 | extreme.

The reference binary cannot be built here (its sources are not in the
repository), so its column is read from BENCH_CORPUS.json, where its
rows were recorded, and labelled "recorded".  The corpus is the pinned
snapshots in tools/corpus/ (engine.py there is the r3 snapshot); a
missing file is an error: nothing else is put in its place, and each
row carries its file's sha256.

    python3 tools/bench_corpus_torch.py [--sizes 2048,4096] [--chains 128]
        [--device {cuda,cpu}] [--out REPORT.json] [anneal flags]

The anneal flags and their defaults are bench_corpus.py's (init=mixed;
BENCH_CORPUS.json's rows used init=optimal).  bench_corpus.py's
--kernel and --platform select JAX paths and are gone; --device cuda
(the default) fails without a card.  --out, if given, names the JSON
report (bench_corpus.py writes BENCH_CORPUS.json by default, the record
this script reads).  Prints one JSON line per (file, size); main()
returns the report as a dict.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import lzma
import os
import sys
import time

import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from megalania_tpu_torch import cli, compressor  # noqa: E402
from megalania_tpu_torch.anneal.config import AnnealConfig  # noqa: E402
from runner_common_torch import baselines  # noqa: E402

CORPUS = [(name, os.path.join(TOOLS, "corpus", name))
          for name in ("survey.md", "pallas.md", "engine.py", "libc.so")]
RECORDED = os.path.join(ROOT, "BENCH_CORPUS.json")


def decodes(blob: bytes, want: bytes) -> bool:
    try:
        return lzma.decompress(blob, format=lzma.FORMAT_ALONE) == want
    except lzma.LZMAError:
        return False


def run_ours(data: bytes, moves: int, chains: int, overrides=None,
             device: str = "cuda") -> dict:
    """compressor.compress of `data` with `moves` total moves after one
    warm-up run of `chains` moves; bench_corpus.py's chain_block rule."""
    device = cli.require_device(device)
    overrides = overrides or {}
    cb = chains if chains % 128 == 0 else 128
    if overrides.get("lc"):
        cb = 128
    cfg = AnnealConfig(chains=chains, chain_block=cb, **overrides)
    compressor.compress(data, cfg, total_moves=chains, device=device)
    t0 = time.perf_counter()
    blob = compressor.compress(data, cfg, total_moves=moves, device=device)
    dt = time.perf_counter() - t0
    return {"bytes": len(blob), "seconds": dt, "moves": moves,
            "moves_per_s": moves / dt, "decodes": decodes(blob, data),
            "sha256": hashlib.sha256(blob).hexdigest()}


def recorded_reference() -> dict:
    """{(file, n): the reference binary's recorded row} from
    BENCH_CORPUS.json."""
    with open(RECORDED) as f:
        rows = json.load(f)["rows"]
    return {(r["file"], r["n"]): r["reference"] for r in rows
            if "reference" in r}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="2048,4096")
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--skip-ref", action="store_true",
                    help="leave out the recorded reference column")
    ap.add_argument("--budget-scale", type=float, default=1.0,
                    help="fraction of the reference budget to run")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sublens", type=int, default=3)
    ap.add_argument("--site-schedule", default="sweep")
    ap.add_argument("--sweep-repeats", type=int, default=4)
    ap.add_argument("--lrep-fallback", default="match")
    ap.add_argument("--site-mode", default="byte")
    ap.add_argument("--proposals", type=int, default=1)
    ap.add_argument("--iters-per-epoch", type=int, default=None)
    ap.add_argument("--num-epochs", type=int, default=200)
    ap.add_argument("--init", default="mixed")
    ap.add_argument("--accept", default="cooled")
    ap.add_argument("--lc", type=int, default=0)
    ap.add_argument("--mixed-greedy-frac", type=float, default=0.5)
    ap.add_argument("--max-candidates", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)
    overrides = dict(sublens=args.sublens, site_schedule=args.site_schedule,
                     sweep_repeats=args.sweep_repeats,
                     lrep_fallback=args.lrep_fallback,
                     site_mode=args.site_mode, proposals=args.proposals,
                     iters_per_epoch=args.iters_per_epoch,
                     num_epochs=args.num_epochs, init=args.init,
                     accept=args.accept,
                     lc=args.lc, mixed_greedy_frac=args.mixed_greedy_frac,
                     max_candidates=args.max_candidates)
    sizes = [int(s) for s in args.sizes.split(",")]
    ref = {} if args.skip_ref or args.budget_scale != 1.0 else (
        recorded_reference())

    report = {"sizes": sizes, "chains": args.chains,
              "budget_scale": args.budget_scale, "overrides": overrides,
              "device": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"), "rows": []}
    for name, path in CORPUS:
        with open(path, "rb") as f:
            raw = f.read()
        for n in sizes:
            if len(raw) < n:
                continue
            data = raw[:n]
            budget = int(3 * 200 * n * args.budget_scale)
            row = {"file": name, "n": n, "budget": budget,
                   "file_sha256": hashlib.sha256(raw).hexdigest(),
                   "xz9e": {"bytes": baselines(data)["liblzma_9e_bytes"]}}
            if (name, n) in ref:
                row["reference"] = dict(ref[(name, n)], recorded=True)
            row["ours"] = run_ours(data, budget, args.chains, overrides,
                                   device)
            report["rows"].append(row)
            print(json.dumps(row), flush=True)
            if not row["ours"]["decodes"]:
                raise RuntimeError(f"{name}[:{n}]: the output does not "
                                   "decode to its input")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
