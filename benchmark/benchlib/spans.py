"""The program's spans in a profiled stretch.

megalania_tpu_torch records named host ranges on the profiler's timeline
(utils/profiling.span); the harness keeps them, with the other host
operations of the thread that drives the device, in
obs["profile"]["host"] as (name, start_us, end_us).  A block emitted
records one `emit` span, so a file's stretch counts its blocks by them.
"""
from __future__ import annotations

BLOCK = "emit"


def _profile(obs: dict, scope: str):
    prof = obs.get("profile")
    return prof if prof and prof.get("scope") == scope else None


def _ms(host, match) -> list:
    """The durations (ms) of the spans whose name `match(name)` accepts."""
    return [(e - s) / 1e3 for name, s, e in host if match(name)]


def per_block_ms(obs: dict, name: str):
    """Summed ms of the spans `name` in a file's stretch over the blocks
    emitted there; None without such a stretch, span or block."""
    prof = _profile(obs, "file")
    if prof is None:
        return None
    ms = _ms(prof["host"], lambda n: n == name)
    blocks = sum(1 for n, _, _ in prof["host"] if n == BLOCK)
    return sum(ms) / blocks if ms and blocks else None


def per_iter_ms(obs: dict, prefix: str):
    """Summed ms of the spans whose names start with `prefix` in a
    stretch of profiled iterations, over its iterations; None without
    such a stretch or span."""
    prof = _profile(obs, "iterations")
    if prof is None or not prof.get("iters"):
        return None
    ms = _ms(prof["host"], lambda n: n.startswith(prefix))
    return sum(ms) / prof["iters"] if ms else None
