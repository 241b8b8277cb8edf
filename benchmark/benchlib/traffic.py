"""The one traffic generator: a mix is a data file of parameters
(traffic/<name>.json) that this module reads.

The inputs of a compressor are real bytes, so a mix names a pinned data
file under the benchmark's folder, its sha256 and the slice it uses.
`kind` says how the slice is offered: "anneal_block" anneals it as one
block (segments of `segment_iters` iterations until the window closes),
"file" compresses it whole, again and again, with `total_moves`.
The run's --seed is the annealer's PRNG seed; with the same seed the
same inputs give the same work.
"""
from __future__ import annotations

import hashlib
import os

from .spec import BENCH_DIR

KINDS = {
    "anneal_block": ("segment_iters", "warmup_iters", "profile_iters",
                     "check_chains"),
    "file": ("total_moves", "warmup_bytes", "warmup_moves"),
}


def validate(mix: dict):
    for key in ("kind", "data", "sha256", "offset", "length"):
        if key not in mix:
            raise ValueError(f"traffic {mix.get('name')}: no {key!r}")
    if mix["kind"] not in KINDS:
        raise ValueError(f"traffic {mix.get('name')}: kind {mix['kind']!r}")
    for key in KINDS[mix["kind"]]:
        if not isinstance(mix.get(key), int) or mix[key] < 0:
            raise ValueError(f"traffic {mix.get('name')}: {key!r} must be "
                             "a whole number")


def data(mix: dict, bench_dir: str = BENCH_DIR) -> bytes:
    """The slice of the pinned data file that the mix offers; raises if
    the file is not the pinned one."""
    validate(mix)
    with open(os.path.join(bench_dir, mix["data"]), "rb") as f:
        raw = f.read()
    if hashlib.sha256(raw).hexdigest() != mix["sha256"]:
        raise ValueError(f"{mix['data']}: sha256 differs from the mix's")
    out = raw[mix["offset"]:mix["offset"] + mix["length"]]
    if len(out) != mix["length"]:
        raise ValueError(f"{mix['data']} is shorter than the mix's slice")
    return out
