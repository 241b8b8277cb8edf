"""Checkpoint / resume (megalania_tpu/utils/checkpoint.py).

The whole AnnealState (slabs, costs, probability snapshots, PRNG keys,
schedule counters) goes to one npz, so a multi-hour run resumes
bit-identically: the PRNG keys are part of the state.

The npz layout is the reference's: `chains.<field>` for the chain
fields, the top-level fields by name, caller metadata as `extra.<key>`;
slabs and PRNG keys are uint32 (keys as [..., 2] key data), everything
else int32.  A checkpoint written by either package therefore resumes in
the other.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..anneal import engine
from . import threefry as R

_FIELDS = ({f"chains.{f}" for f in engine.ChainState._fields}
           | {f for f in engine.AnnealState._fields if f != "chains"})
# fields AnnealState grew with the sweep schedule; files written before
# it load with defaults (sweep_j=0 forces a fresh full walk, which is
# always exact), so an old run still resumes, though not bit-identically
_SWEEP_FIELDS = ("chains.snap_carry", "sweep_j", "snap_pos", "u_prev",
                 "skey")


def save(path: str, state: engine.AnnealState, extra: dict | None = None
         ) -> None:
    """Write the state (plus caller metadata arrays under "extra.") to
    `path`, atomically: a crash leaves the previous file intact."""
    st = engine.state_to_numpy(state)
    arrays = {f"chains.{f}": v for f, v in st.pop("chains").items()}
    arrays.update({f: np.asarray(v) for f, v in st.items()})
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_extra(path: str, key: str):
    """One "extra." metadata array of a checkpoint (None if absent)."""
    with np.load(path) as z:
        name = f"extra.{key}"
        return z[name] if name in z.files else None


def load(path: str, device) -> engine.AnnealState:
    """The AnnealState of a one-block checkpoint, on `device`.  Files
    that predate the sweep fields get their defaults; any other missing
    array raises the "incompatible checkpoint" ValueError."""
    with np.load(path) as z:
        names = set(z.files)
        missing = sorted(_FIELDS - names - set(_SWEEP_FIELDS))
        if missing:
            raise ValueError(
                f"incompatible checkpoint {path!r}: missing required "
                f"arrays {missing} (delete the file to restart)")
        if z["chains.slab"].ndim != 2:
            raise ValueError(
                f"incompatible checkpoint {path!r}: chains.slab has shape "
                f"{z['chains.slab'].shape}, expected one block's [C, n]")
        C = z["chains.slab"].shape[0]
        defaults = {
            "chains.snap_carry": np.zeros((C, 16), np.int32),
            "skey": R.PRNGKey(0).numpy().astype(np.uint32),
            "sweep_j": np.int32(0), "snap_pos": np.int32(0),
            "u_prev": np.int32(0)}
        arr = {k: (z[k] if k in names else defaults[k]) for k in _FIELDS}
    st = {f: arr[f] for f in engine.AnnealState._fields if f != "chains"}
    st["chains"] = {f: arr[f"chains.{f}"] for f in engine.ChainState._fields}
    return engine.state_from_numpy(st, device)
