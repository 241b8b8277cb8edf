#!/usr/bin/env python3
"""One 64 KiB block end to end on the card: anneal, emit, decode.

The port of tools/run_64k_block.py to megalania_tpu_torch.  The block is
tools/corpus/survey.md followed by tools/corpus/pallas.md, repeated to
RUN64K_N bytes and cut: the reference's SURVEY.md and Pallas guide, byte
for byte, so its first 65,536 B are the reference runner's (sha256
14b7b618...8e290c91a).  The arguments, defaults and chain_block rule are
the reference runner's; the block goes through the port's
compressor.compress_block on --device, is decoded with Python's lzma
(FORMAT_ALONE), and is compared with liblzma's own preset 9 | extreme.

    python3 tools/run_64k_block_torch.py [moves] [chains] [lc] [init]
        [accept] [--device {cuda,cpu}] [-o OUT]

moves defaults to 128 x chains, chains to 512, lc to 0, init to mixed,
accept to cooled.  RUN64K_N sets the block size (default 65536);
RUN64K_CKPT names a checkpoint file, saved every 4 segments, from which
the same command resumes exactly.  --device cuda (the default) fails
without a card.  Prints one JSON line; main() returns it as a dict.
"""
from __future__ import annotations

import argparse
import hashlib
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
from runner_common_torch import baselines, finish  # noqa: E402

CORPUS = [os.path.join(ROOT, "tools", "corpus", f)
          for f in ("survey.md", "pallas.md")]


def corpus(n: int) -> bytes:
    raw = b"".join(open(p, "rb").read() for p in CORPUS)
    return (raw * (n // len(raw) + 1))[:n]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("moves", nargs="?", type=int,
                    help="total anneal moves (default 128 x chains)")
    ap.add_argument("chains", nargs="?", type=int, default=512)
    ap.add_argument("lc", nargs="?", type=int, default=0)
    ap.add_argument("init", nargs="?", default="mixed")
    ap.add_argument("accept", nargs="?", default="cooled")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("-o", "--output", help="write the .lzma stream here")
    args = ap.parse_args(argv)
    device = cli.require_device(args.device)
    n = int(os.environ.get("RUN64K_N", 1 << 16))
    moves = 128 * args.chains if args.moves is None else args.moves

    data = corpus(n)
    cfg = AnnealConfig(chains=args.chains,
                       chain_block=cli.chain_block(args.chains, args.lc),
                       block_size=n, lc=args.lc, init=args.init,
                       accept=args.accept)
    ck = os.environ.get("RUN64K_CKPT")
    segments = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = compressor.compress_block(
        data, cfg, total_moves=moves, checkpoint_path=ck,
        checkpoint_every=4, resume=bool(ck), progress=segments.append,
        device=device)
    dt = time.time() - t0
    out = {
        "n": n, "chains": args.chains, "chain_block": cfg.chain_block,
        "lc": args.lc, "init": args.init, "accept": args.accept,
        "corpus_sha256": hashlib.sha256(data).hexdigest(),
        "moves": res.moves,
        "seconds": round(dt, 1),
        # the reference's two columns below use compress_block's own
        # clock, the seed, context and emission included
        "anneal_seconds": round(res.seconds, 1),
        "moves_per_s": round(res.moves / max(res.seconds, 1e-9), 1),
        # the progress lines: each segment's own moves/s and best
        "segments": [{k: s[k] for k in ("iter", "moves_per_sec",
                                        "best_bytes")} for s in segments],
        "bytes": len(res.stream), "predicted": res.predicted_bytes,
        **baselines(data),
        "decode_ok": lzma.decompress(res.stream,
                                     format=lzma.FORMAT_ALONE) == data,
    }
    return finish(out, res.stream, args.output, device)


if __name__ == "__main__":
    main()
