"""One run of one cell: its function of cells.DRIVERS on each of the
cell's cards, then the result line.

A cell of one chip runs its driver in this process.  A cell of several
chips starts one process a card (`rank_main`), each with torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=127.0.0.1, a
free MASTER_PORT, and OMP_NUM_THREADS=1 unless it is set).  Each rank
joins the process group through the program's own bootstrap,
parallel.multihost.initialize (nccl on cuda, gloo on cpu), as
`cli.py --distributed` does, takes the chain group of
parallel.mesh.make_mesh(1) (one block group of all the ranks) and runs
the cell's driver on its card.  Its part comes back through a pipe and
the parts are folded into one (`fold`).  If a rank exits with an error,
or the deadline passes, every rank is killed and RankFailure raised, so
that no result is printed.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time

from . import cells, check, spec as spec_mod

# seconds a run of several ranks may take beyond its window: set-up (a
# first run in a checkout also builds the native libraries), the traced
# stretch and the check, with room to spare; within run.py's 360 s at
# the benchmark's 50 s window
RANK_SLACK_S = 240.0


class RankFailure(RuntimeError):
    """A rank exited with an error, or the ranks outran the deadline."""


def drive(payload: dict, rank: int = 0, group=None) -> dict:
    """The cell's driver on this process's card, with the faults that
    `payload["plants"]` names for this rank planted ([name, ranks],
    ranks None for all)."""
    import torch
    local = 0 if group is None else int(os.environ["LOCAL_RANK"])
    dev = (torch.device("cuda", local) if payload["device_type"] == "cuda"
           else torch.device("cpu"))
    driver = cells.DRIVERS[payload["mix"]["kind"]]
    with contextlib.ExitStack() as stack:
        for name, ranks in payload.get("plants", ()):
            if ranks is None or rank in ranks:
                from . import faults
                stack.enter_context(faults.planted(name))
        part = driver(payload["conf"], payload["mix"], payload["seed"],
                      payload["seconds"], payload["trace"], dev, group=group)
    if dev.type == "cuda":
        part["kind"] = torch.cuda.get_device_name(dev)
    return part


def _die_with_parent(parent: int):
    """Have the kernel kill this process when the one that started it
    ends (Linux), so that no rank outlives a run that was cut."""
    import ctypes
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def rank_main():
    """The body of one rank's process: the payload arrives on standard
    input, the part leaves, pickled, through the pipe that was standard
    output (the program's own prints go to standard error)."""
    payload = pickle.load(sys.stdin.buffer)
    _die_with_parent(payload["parent"])
    pipe = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    import torch.distributed as dist
    from megalania_tpu_torch.parallel import mesh, multihost
    rank = multihost.initialize(payload["device_type"])
    part = drive(payload, rank, mesh.make_mesh(1).chain_group)
    part["jax"] = sorted(set(part["jax"]) | set(cells.forbidden_modules()))
    if rank:
        # rank 0's trace is the one read; the others send their numbers
        for key in ("obs", "breakdown", "judged"):
            part.pop(key, None)
    pickle.dump(part, pipe)
    pipe.close()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def rank_parts(payload: dict, world: int, deadline_s: float) -> list:
    """Run the cell on `world` ranks, one process each; their parts in
    rank order.  Raises RankFailure, with every rank killed, when one
    exits with an error or they are not all done in `deadline_s`."""
    bench = spec_mod.BENCH_DIR
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from benchlib import runner; runner.rank_main()"
            % (bench, os.path.dirname(bench)))
    port = _free_port()
    payload = dict(payload, parent=os.getpid())
    procs, outs = [], [b""] * world
    try:
        for r in range(world):
            # torchrun's environment, one host thread a rank included
            env = dict({"OMP_NUM_THREADS": "1"}, **os.environ)
            env.update(RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, "rank", str(r)], env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                start_new_session=True))
        for p in procs:
            p.stdin.write(pickle.dumps(payload))
            p.stdin.close()

        def read(r):
            outs[r] = procs[r].stdout.read()
        readers = [threading.Thread(target=read, args=(r,), daemon=True)
                   for r in range(world)]
        for t in readers:
            t.start()
        t_end = time.monotonic() + deadline_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                # the others may have followed the first out by now
                raise RankFailure("; ".join(
                    f"rank {r} exited with code {codes[r]}" for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                raise RankFailure(f"the ranks were not done within "
                                  f"{deadline_s:.0f} s")
            time.sleep(0.05)
        for t in readers:
            t.join()
    finally:
        _kill(procs)
    parts = []
    for r, raw in enumerate(outs):
        if not raw:
            raise RankFailure(f"rank {r} sent no result")
        parts.append(pickle.loads(raw))
    return parts


def fold(spec: dict, parts: list) -> dict:
    """The ranks' parts as one: each end-to-end value the worst rank's
    (by the metric's `better`; a rate's window is the longest), the
    window opened when the last rank was set up, the numbers compared
    folded (check.fold) with `ranks_disagree`, the memory peak of the
    fullest card, busy and window seconds averaged over the cards, and
    rank 0's trace, breakdown and judged outputs."""
    if len(parts) == 1:
        return parts[0]
    better = {m["name"].split(".")[0]: m["better"]
              for m in spec["end_to_end"]}
    out = dict(parts[0])
    out["e2e"] = {k: (max if better.get(k) == "lower" else min)(
        p["e2e"][k] for p in parts) for k in parts[0]["e2e"]}
    out["setup_end"] = max(p["setup_end"] for p in parts)
    out["jax"] = sorted({m for p in parts for m in p["jax"]})
    out["checks"] = check.fold([p["checks"] for p in parts])
    out["checks"].update(check.ranks([p["answer"] for p in parts]))
    dev = {"memory_peak_bytes": max(p["device"].get("memory_peak_bytes", 0)
                                    for p in parts)}
    for key in ("busy_s", "window_s"):
        if all(key in p["device"] for p in parts):
            dev[key] = sum(p["device"][key] for p in parts) / len(parts)
    out["device"] = dev
    out["count"] = len(parts)
    return out


def parts_of(spec: dict, wl: dict, payload: dict,
             deadline_s: float = None) -> dict:
    """The cell's part: its driver in this process on one chip, or on
    one rank a card, folded."""
    if wl["chips"] == 1:
        return drive(payload)
    if deadline_s is None:
        deadline_s = payload["seconds"] + RANK_SLACK_S
    return fold(spec, rank_parts(payload, wl["chips"], deadline_s))


def assemble(spec: dict, wl: dict, part: dict, trace: bool,
             t_start: float, bench_dir: str = spec_mod.BENCH_DIR) -> dict:
    """The result line of one run.  An end-to-end metric named
    `<name>.<tag>` is the part's `<name>`, kept apart for the cells
    its `workloads` list."""
    checks = part["checks"]
    ok = check.verdict(checks)
    metrics = {}
    if trace:
        obs = dict(part["obs"], device_kind=part.get("kind", "cpu"))
        for m in spec_mod.cell_metrics(spec, wl["name"], "per_layer"):
            v = spec_mod.metric_reader(m["name"], bench_dir)(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec_mod.cell_metrics(spec, wl["name"], "end_to_end"):
            v = (part["setup_end"] - t_start if m["name"] == "setup_s"
                 else part["e2e"][m["name"].split(".")[0]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if "kind" in part else "cpu",
              "kind": part.get("kind", "cpu"), "count": part.get("count", 1),
              "memory_peak_bytes": part["device"].get("memory_peak_bytes",
                                                      0)}
    out = {"correct": ok, "attempted": part["outputs"],
           "failed": 0 if ok else max(1, checks.get("outputs_differ", 0)),
           "metrics": metrics, "device": device}
    if trace and "busy_s" in part["device"]:
        device["busy_s"] = part["device"]["busy_s"]
        device["window_s"] = part["device"]["window_s"]
        out["breakdown"] = part["breakdown"]
    out["checks"] = check.table(checks)
    return out


def run_cell(spec: dict, wl: dict, conf: dict, mix: dict, seed: int,
             seconds: float, trace: bool, t_start: float,
             device_type: str = "cuda", plants=(),
             deadline_s: float = None) -> tuple:
    """(result line, modules of the JAX stack found loaded).  Raises
    RankFailure where a cell of several chips could not finish."""
    payload = {"conf": conf, "mix": mix, "seed": seed, "seconds": seconds,
               "trace": trace, "device_type": device_type,
               "plants": [list(p) for p in plants]}
    part = parts_of(spec, wl, payload, deadline_s)
    jax = sorted(set(cells.forbidden_modules()) | set(part["jax"]))
    return assemble(spec, wl, part, trace, t_start), jax
