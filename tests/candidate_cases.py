"""Blocks and table shapes on which the candidate-table kernel
(megalania_tpu_torch/csrc/candidates.cu) is held to the numpy builder
(match/candidates.build_candidates): on the CPU through a scalar walk
that mirrors the kernel's loop (test_torch_candidates.py), on the card
through the kernel itself (test_torch_cuda.py).  Plain numpy: no jax.
"""
import functools
import os

import numpy as np

from megalania_tpu_torch.match import candidates as C_
from megalania_tpu_torch.match.suffix import build_lce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tools", "corpus")

# case id -> (block, max_candidates, max_walk): the annealer's table is
# 16 x 96 by default (20 x 96 tried too), the optimum-parse seed's
# 64 x 1,024
CASES = {
    "libc64k-16x96": ("libc64k", 16, 96),
    "libc64k-20x96": ("libc64k", 20, 96),
    "libc64k-64x1024": ("libc64k", 64, 1024),
    "survey2k-20x96": ("survey2k", 20, 96),
    "n0": ("n0", 20, 96),
    "n1": ("n1", 20, 96),
    "n2": ("n2", 20, 96),
    "n3": ("n3", 20, 96),
    "byte64k-64x1024": ("byte64k", 64, 1024),
    "stairs20-20x96": ("stairs20", 20, 96),
    "stairs64-64x1024": ("stairs64", 64, 1024),
    "stairs64-20x96": ("stairs64", 20, 96),
}
# a wide block (over the packed format's 1 MiB) at the seed's table, which
# the DP-only path builds on the card: held there only, since its numpy
# table takes tens of seconds
WIDE_CASES = {"libc1088k-64x1024": ("libc1088k", 64, 1024)}


def stairs(levels: int, copies: int = 4) -> bytes:
    """A period of prefixes T[:levels+1], ..., T[:2] of a run T of
    distinct bytes, each ended by a byte T lacks, then T itself, repeated
    `copies` times.  Nearest first, T's bigram recurs with extensions 2,
    3, ..., levels+1: each extends further than every nearer one, so the
    table of T's first position fills `levels` slots."""
    t = bytes(range(0x40, 0x40 + levels + 2))
    period = b"".join(t[:k] + b"#" for k in range(levels + 1, 1, -1)) + t
    return period * copies


@functools.cache
def block(name: str) -> np.ndarray:
    if name.startswith("libc"):        # libc<KiB>k
        raw = open(os.path.join(CORPUS, "libc.so"),
                   "rb").read()[:int(name[4:-1]) << 10]
    elif name == "survey2k":
        raw = open(os.path.join(CORPUS, "survey.md"), "rb").read()[:2048]
    elif name == "byte64k":
        raw = b"\x00" * 65536      # every walk stops at the 273 cap
    elif name.startswith("stairs"):
        raw = stairs(int(name[len("stairs"):]))
    else:
        raw = b"a" * int(name[1:])
    return np.frombuffer(raw, np.uint8)


@functools.cache
def index(name: str):
    return build_lce(block(name))


@functools.cache
def numpy_table(case: str) -> C_.CandidateTable:
    name, M, walk = {**CASES, **WIDE_CASES}[case]
    return C_.build_candidates(block(name), M, walk, index(name))
