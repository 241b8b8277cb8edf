#!/usr/bin/env python3
"""A 4 MiB corpus through the full pipeline (block split, per-block
optimum parse and anneal, .mlz container, decode), beside liblzma's
preset 9 | extreme and gzip -9.

The port of tools/run_4mib_corpus.py to megalania_tpu_torch, with the
same arguments and configuration (128 chains, init=optimal,
accept=greedy).  Its corpus is built from files in the repository only:
tools/corpus/libc.so, pallas.md, survey.md and engine.py in that order,
repeated and cut to the corpus size.  That is NOT the reference's 4 MiB
corpus (PERF_4MIB.json, sha256 a1964508...), which adds files outside the
repository after libc, so its bytes do not compare with the recorded
ones.  It starts with libc, as the reference's does, so a corpus size of
1 MiB is PERF_1MIB.json's corpus (sha256 36432546...): with lc=4 and one
1 MiB block, DP-only, the recorded output is 432,156 B.

    python3 tools/run_4mib_corpus_torch.py [moves_per_block] [lc] [block]
        [corpus_bytes] [--device {cuda,cpu}] [-o OUT]

moves_per_block 0 (the default) is DP-only: the optimum-parse seed of
each block, its candidate table built on --device and its DP and
emission on the host; blocks over 1 MiB run the wide pipeline, which is
DP-only.  lc defaults to 3, block
to 1 MiB, corpus_bytes to 4 MiB.  --device cuda (the default) fails
without a card.  Prints one JSON line; main() returns it as a dict.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from megalania_tpu_torch import cli, compressor  # noqa: E402
from megalania_tpu_torch.anneal.config import AnnealConfig  # noqa: E402
from runner_common_torch import SHA256_1MIB, baselines, finish  # noqa: E402

FILES = [os.path.join(ROOT, "tools", "corpus", f)
         for f in ("libc.so", "pallas.md", "survey.md", "engine.py")]


def corpus(size: int = 4 << 20) -> bytes:
    raw = b"".join(open(p, "rb").read() for p in FILES)
    return (raw * (size // len(raw) + 1))[:size]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("moves_per_block", nargs="?", type=int, default=0,
                    help="anneal moves per block; 0 = DP-only")
    ap.add_argument("lc", nargs="?", type=int, default=3)
    ap.add_argument("block", nargs="?", type=int, default=1 << 20)
    ap.add_argument("corpus_bytes", nargs="?", type=int, default=4 << 20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-o", "--output", help="write the .mlz container here")
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)

    data = corpus(args.corpus_bytes)
    sha = hashlib.sha256(data).hexdigest()
    cfg = AnnealConfig(chains=128, block_size=args.block, lc=args.lc,
                       init="optimal", accept="greedy")
    n_blocks = -(-len(data) // cfg.block_size)
    t0 = time.time()
    blob = compressor.compress(
        data, cfg, total_moves=args.moves_per_block * n_blocks,
        device=device)
    dt = time.time() - t0
    base = baselines(data)
    out = {
        "corpus_bytes": len(data), "corpus_sha256": sha,
        "corpus": ("PERF_1MIB.json's corpus" if sha == SHA256_1MIB else
                   "in-repo files, not the reference's 4 MiB corpus"),
        "blocks": n_blocks, "block_size": cfg.block_size, "lc": args.lc,
        "moves_per_block": args.moves_per_block,
        "pipeline": "dp_only" if args.moves_per_block == 0 else "anneal",
        "bytes": len(blob), **base,
        "vs_liblzma_9e": round(len(blob) / base["liblzma_9e_bytes"] - 1, 4),
        "vs_gzip": round(len(blob) / base["gzip9_bytes"] - 1, 4),
        "seconds": round(dt, 1),
        "decode_ok": compressor.decompress(blob) == data,
    }
    return finish(out, blob, args.output, device)


if __name__ == "__main__":
    main()
