#!/usr/bin/env python3
"""A 1 MiB corpus through compressor.compress on the card: 16 blocks of
64 KiB, each annealed in turn, in one .mlz container, decoded again.

The port of tools/run_1mib_corpus.py to megalania_tpu_torch.  The corpus
is the first 1 MiB of tools/corpus/libc.so, which is the reference
runner's corpus byte for byte (sha256 36432546...56b8db6, as recorded in
PERF_1MIB.json; checked).  Chains default to 512 with the reference's
chain_block rule, and moves per block to 256 x chains.  Prints one JSON
line: the bytes beside liblzma's preset 9 | extreme and gzip -9, the
seconds, and how they split between annealing (the progress lines'
moves/s) and the rest (host seed, block context, emission).

    python3 tools/run_1mib_corpus_torch.py [moves_per_block] [chains]
        [--device {cuda,cpu}] [-o OUT]

--device cuda (the default) fails without a card.  main() returns the
JSON object as a dict; its corpus_bytes and block_size keywords shrink
the run for tests (the corpus is then a prefix of libc.so).
"""
from __future__ import annotations

import argparse
import hashlib
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
from runner_common_torch import SHA256_1MIB, baselines, finish  # noqa: E402

LIBC = os.path.join(ROOT, "tools", "corpus", "libc.so")
TARGET = 1 << 20


def corpus(size: int = TARGET) -> bytes:
    raw = open(LIBC, "rb").read()
    data = (raw * (size // len(raw) + 1))[:size]
    if size == TARGET and hashlib.sha256(data).hexdigest() != SHA256_1MIB:
        raise RuntimeError("tools/corpus/libc.so[:1 MiB] is not the "
                           "recorded corpus of PERF_1MIB.json")
    return data


def main(argv=None, corpus_bytes: int = TARGET,
         block_size: int = 1 << 16) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("moves_per_block", nargs="?", type=int,
                    help="anneal moves per block (default 256 x chains)")
    ap.add_argument("chains", nargs="?", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-o", "--output", help="write the .mlz container here")
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)
    per_block = (256 * args.chains if args.moves_per_block is None
                 else args.moves_per_block)

    data = corpus(corpus_bytes)
    cfg = AnnealConfig(chains=args.chains,
                       chain_block=cli.chain_block(args.chains),
                       block_size=block_size)
    n_blocks = -(-len(data) // block_size)
    total = per_block * n_blocks
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # per block: its anneal seconds (each segment's moves over its
    # moves/s), its wall seconds from one block's last progress line to
    # the next (the seed, context and first full walk of this block and
    # the emission of the one before it fall in there), and the device
    # memory held while its last segment ended
    blocks = {}
    last = [0.0]

    def progress(info):
        now = time.time()
        b = blocks.setdefault(info["block"], dict(
            block=info["block"], moves=0, anneal_s=0.0, wall_s=0.0))
        b["anneal_s"] += ((info["moves"] - b["moves"])
                          / max(info["moves_per_sec"], 1e-9))
        b["moves"] = info["moves"]
        b["wall_s"] += now - last[0]
        b["best_bytes"] = info["best_bytes"]
        if cuda:
            b["allocated_bytes"] = torch.cuda.memory_allocated()
        last[0] = now

    t0 = last[0] = time.time()
    blob = compressor.compress(data, cfg, total_moves=total,
                               progress=progress, device=device)
    dt = time.time() - t0
    anneal_s = sum(b["anneal_s"] for b in blocks.values())
    out = {
        "n": len(data), "corpus_sha256": hashlib.sha256(data).hexdigest(),
        "blocks": n_blocks, "block_size": block_size,
        "chains": args.chains, "chain_block": cfg.chain_block,
        "moves": total, "seconds": round(dt, 2),
        "moves_per_s": round(total / dt, 1),
        "anneal_seconds": round(anneal_s, 2),
        "anneal_moves_per_s": round(total / max(anneal_s, 1e-9), 1),
        "other_seconds": round(dt - anneal_s, 2),
        "per_block": [{k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in blocks[bi].items()}
                      for bi in sorted(blocks)],
        "bytes": len(blob), **baselines(data),
        "decode_ok": compressor.decompress(blob) == data,
    }
    return finish(out, blob, args.output, device)


if __name__ == "__main__":
    main()
