"""The cell drivers: set-up, the measured window, the traced stretch, and
the outputs the check compares.  The one module of the benchmark that
imports the program under test (megalania_tpu_torch).

A driver returns a dict: `e2e` (end-to-end values), `obs` (what the
per-layer readers read), `device` (peak memory, and busy and window
seconds of the traced stretch), `breakdown`, `checks`, `judged` (the
blocks, their streams and the engine's costs that the check compared),
`answer` and `units` (anneal cells: what every chain rank must agree
on, and the window's segments),
`setup_end` (wall-clock time at which the window opened) and `jax`
(modules of the JAX stack found loaded).
"""
from __future__ import annotations

import contextlib
import hashlib
import sys
import time

import numpy as np
import torch

from . import check, devtrace, reference, traffic as traffic_mod, window

FORBIDDEN = ("jax", "jaxlib", "flax", "megalania_tpu")
SPAN = "bench."
STRETCH = SPAN + "stretch"
NAME_CHARS = 160          # device operation names in the breakdown


def forbidden_modules() -> list:
    """Modules of the JAX stack or the JAX package in this process,
    compared by whole top-level names."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def anneal_config(conf: dict, seed: int):
    from megalania_tpu_torch.anneal.config import AnnealConfig
    return AnnealConfig(**conf["anneal"], seed=int(seed))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reduce(prof, wall: float, scope: str, iters: int) -> dict:
    """The profiled stretch as plain data (devtrace's input)."""
    from torch.autograd import DeviceType
    dev, host, marks = [], [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # the device's copies of host annotations (the harness's spans,
            # the process group's "nccl:<collective>" ranges) are no
            # operations
            if not (e.name.startswith(SPAN)
                    or getattr(e, "is_user_annotation", False)):
                dev.append(span)
        elif e.name == STRETCH:
            marks.append((span, e.thread))
        else:
            host.append(span + (e.thread,))
    t0 = t1 = 0.0
    thread = None
    if marks:
        (_, t0, t1), thread = marks[0]
    # what ran before the stretch opened (the ranks' meeting) is not of it
    dev = [d for d in dev if d[1] >= t0]
    host = [h[:3] for h in host if h[3] == thread and h[1] >= t0]
    return {"scope": scope, "iters": iters, "wall_s": wall, "dev": dev,
            "host": host, "t0": t0, "t1": t1}


@contextlib.contextmanager
def profiled(obs: dict, scope: str, iters: int, dev, agree=None):
    """Profile the enclosed stretch (host and device) into obs["profile"];
    its wall time is taken between two device synchronisations.  With
    `agree` (a cell of several cards) the ranks meet once their
    profilers run, so that none waits in the stretch's first collective
    for another's profiler to start."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _sync(dev)
        if agree is not None:
            agree(False)
        with torch.profiler.record_function(STRETCH):
            t0 = time.perf_counter()
            yield
            _sync(dev)
            wall = time.perf_counter() - t0
    obs["profile"] = _reduce(prof, wall, scope, iters)


@contextlib.contextmanager
def patched(module, name: str, make):
    """Replace module.<name> by make(original) for the enclosed block.
    Function attributes (the kernels' launch counters) follow the
    replacement and are copied back."""
    orig = getattr(module, name)
    new = make(orig)
    new.__dict__.update(orig.__dict__)
    setattr(module, name, new)
    try:
        yield
    finally:
        orig.__dict__.update({k: v for k, v in new.__dict__.items()
                              if k in orig.__dict__})
        setattr(module, name, orig)


def _recording_launches(obs: dict):
    """Wrap repair_cost_cuda: each launch's chains, n, re-cost start (a
    device scalar, read after the stretch) and packed rows."""
    rec = obs.setdefault("repair_launches_raw", [])

    def make(orig):
        def wrapper(slabs, *a, start_pos=None, **kw):
            out = orig(slabs, *a, start_pos=start_pos, **kw)
            C, n = slabs.shape
            rec.append((C, n, 0 if start_pos is None else start_pos,
                        out[3].shape[1]))
            return out
        return wrapper
    return make


def _timed(obs: dict, key: str):
    """Wrap a module-level call of the program with a host-clock timer
    and a named span."""
    rec = obs.setdefault("timers", {}).setdefault(key, [])

    def make(orig):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(SPAN + key):
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                rec.append(time.perf_counter() - t0)
            return out
        return wrapper
    return make


def _finish_launches(obs: dict):
    raw = obs.pop("repair_launches_raw", [])
    obs["repair_launches"] = [(C, n, int(s), pr) for C, n, s, pr in raw]


def _trace_outputs(out: dict, obs: dict):
    prof = obs.get("profile")
    if prof is None:
        return
    out["device"]["busy_s"] = devtrace.busy_union_seconds(prof["dev"])
    out["device"]["window_s"] = prof["wall_s"]
    out["breakdown"] = {
        "device_ops": [[name[:NAME_CHARS], s]
                       for name, s in devtrace.top_ops(prof["dev"])],
        "idle_gaps": devtrace.idle_gaps(prof["dev"], prof["host"],
                                        prof["t0"], prof["t1"])}


class MoveWatch:
    """Whether each chain's parse moved in the window, by a wrapper on
    engine.anneal_iteration.  A chain's parse is compared with the one
    it held when its block's anneal started in the window, or at the
    last epoch restart (which reseeds every chain): just before each
    restart and when the block ends.  A chain that never differs has
    not moved.  `steps` counts the iterations seen, so that steps
    skipped around the engine's counters show too.  One clone and one
    comparison of the chains per epoch; nothing is read back before
    `unmoved()`."""

    def __init__(self):
        self.base = self.moved = self.last = None
        self.counts = []
        self.steps = 0

    def _close(self):
        if self.last is not None:
            slab = self.last.chains.slab
            self.moved = self.moved | (slab != self.base).any(1)
            self.counts.append((~self.moved).sum())
        self.base = self.moved = self.last = None

    def wrap(self, orig):
        def wrapper(state, *a, **kw):
            slab = state.chains.slab
            if self.base is None or state.moves_done == 0:
                self._close()                   # a new block begins
                self.base = slab.clone()
                self.moved = torch.zeros(slab.shape[0], dtype=torch.bool,
                                         device=slab.device)
            out = orig(state, *a, **kw)
            self.steps += 1
            if out.epochs_done != state.epochs_done:
                # the step before the restart is not compared; the
                # epoch's other steps are
                self.moved = self.moved | (slab != self.base).any(1)
                self.base = out.chains.slab.clone()
            self.last = out
            return out
        return wrapper

    def unmoved(self) -> int:
        """Chains that never moved, summed over the blocks watched."""
        self._close()
        return int(sum(int(c) for c in self.counts))


class CaptureCount:
    """The all-reduces MIN over the chain group (the capture position's,
    engine._chains_iter, one an iteration under the sweep schedule), by
    a wrapper on torch.distributed.all_reduce: the program keeps no
    counter of them, as it does of mesh.exchange_best's gathers."""

    def __init__(self, group):
        self.group = group
        self.calls = 0

    def wrap(self, orig):
        import torch.distributed as dist

        def wrapper(tensor, *a, **kw):
            if (kw.get("group") is self.group
                    and kw.get("op") == dist.ReduceOp.MIN):
                self.calls += 1
            return orig(tensor, *a, **kw)
        return wrapper


def _agree(done: bool, group, dev) -> bool:
    """True on every rank of `group` once any of them is done (an
    all-reduce of the flag)."""
    import torch.distributed as dist
    flag = torch.tensor([int(done)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def anneal_block(conf: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, dev, group=None) -> dict:
    """Anneal one block from its initial parse in segments of
    `segment_iters` iterations (engine.run_iters) until the window
    closes; then emit the best parse (runtime.emit.emit).

    With a chain group (parallel.mesh) this process holds its rank's
    share of the chains, as compressor.compress_block runs it: the
    ranks open the window together, agree after every segment whether
    it has closed, and each checks its own rows, best and stream, and
    that every iteration ran the group's best exchange
    (mesh.exchange_best's gathers) and capture all-reduce
    (CaptureCount)."""
    data = traffic_mod.data(mix)
    cfg = anneal_config(conf, seed)
    stack = contextlib.ExitStack()
    if group is not None:
        import torch.distributed as dist
        from megalania_tpu_torch.parallel import mesh
        gathers = mesh.exchange_best.scalar_gathers
        captures = CaptureCount(group)
        stack.enter_context(patched(dist, "all_reduce", captures.wrap))
    with stack:
        out = _anneal_block(conf, mix, seed, seconds, trace, dev, group,
                            data, cfg)
    done = out.pop("iters_done")
    if group is not None:
        # every iteration run exchanged the best and captured at the
        # block's lowest site over all the chain ranks
        out["checks"]["exchange_gap"] = abs(
            done - (mesh.exchange_best.scalar_gathers - gathers))
        out["checks"]["capture_gap"] = abs(done - captures.calls)
    return out


def _anneal_block(conf, mix, seed, seconds, trace, dev, group, data, cfg):
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.ops import repair_cuda
    from megalania_tpu_torch.runtime import emit as emit_mod
    from megalania_tpu_torch.utils import fixedpoint as fp

    ctx = engine.make_context(data, cfg, dev)
    state = engine.init_state(ctx, cfg, group)
    state = engine.run_iters(state, ctx, cfg, mix["warmup_iters"], group)
    _sync(dev)
    seg = mix["segment_iters"]

    def unit():
        nonlocal state
        state = engine.run_iters(state, ctx, cfg, seg, group)
        _sync(dev)

    agree = None
    if group is not None:
        def agree(done):
            return _agree(done, group, dev)
        agree(False)                    # the ranks open the window together
    watch = MoveWatch()
    setup_end = time.time()
    with patched(engine, "anneal_iteration", watch.wrap):
        units, elapsed = window.run_window(unit, seconds, agree=agree)
    jax = forbidden_modules()
    unmoved = watch.unmoved()
    iters = seg * len(units)
    out = {"setup_end": setup_end, "jax": jax, "device": {}, "obs": {},
           "units": len(units),
           "e2e": {"moves_per_s": window.rate(
               window.moves(cfg.chains, cfg.proposals, iters), elapsed)}}
    done = mix["warmup_iters"] + iters
    obs = out["obs"]
    obs["unit_wall_s"] = elapsed / iters        # one iteration, unprofiled
    obs["window_moves_per_s"] = out["e2e"]["moves_per_s"]
    if trace:
        k = mix["profile_iters"]
        with patched(repair_cuda, "repair_cost_cuda",
                     _recording_launches(obs)), \
                profiled(obs, "iterations", k, dev, agree):
            state = engine.run_iters(state, ctx, cfg, k, group)
        done += k
        _finish_launches(obs)
        _trace_outputs(out, obs)
    if dev.type == "cuda":
        out["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)

    # the outputs: best parse, its cost, a sample of chains, the moves
    best = P.to_u32(state.best_slab)
    best_cost = fp.to_int(state.best_hi, state.best_lo)
    rng = np.random.default_rng(int(seed))
    rows = rng.choice(state.chains.slab.shape[0],
                      size=min(mix["check_chains"],
                               state.chains.slab.shape[0]), replace=False)
    inf = int(fp.INF_HI)
    sample = []
    for r in sorted(rows.tolist()):
        hi = int(state.chains.cost_hi[r])
        sample.append((P.to_u32(state.chains.slab[r]),
                       None if hi == inf
                       else fp.to_int(hi, state.chains.cost_lo[r])))
    moves_done = state.moves_done
    del state, ctx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_step = window.moves(cfg.chains, cfg.proposals, 1)
    checks = {
        "moves_gap": max(abs(moves_done - per_step * done),
                         per_step * abs(watch.steps - iters)),
        "chains_unmoved": unmoved}
    checks.update(check.chains(data, sample, cfg.lc))
    stream = emit_mod.emit(data, best, dict_size=cfg.dict_size, lc=cfg.lc)
    out["e2e"]["out_bytes"] = len(stream)
    out["answer"] = (best_cost, hashlib.sha256(best.tobytes()).hexdigest(),
                     hashlib.sha256(stream).hexdigest())
    checks.update(check.streams([data], [stream], [best_cost]))
    out["judged"] = ([data], [stream], [best_cost])
    out["outputs"] = 1
    out["checks"] = checks
    out["iters_done"] = done
    return out


def _block_cost(res) -> int:
    """The engine's exact cost of a block's best parse, from
    BlockResult.predicted_bytes = 18 + cost / 16384 (exact in float64)."""
    return int(round((res.predicted_bytes - 18.0) * 16384.0))


def file(conf: dict, mix: dict, seed: int, seconds: float, trace: bool,
         dev, group=None) -> dict:
    """Compress the whole file (compressor.compress) again and again
    until the window closes; every file of a run has the run's seed.
    One card: it takes no chain group."""
    if group is not None:
        raise ValueError("the file driver runs on one card")
    from megalania_tpu_torch import compressor
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.runtime import emit as emit_mod

    data = traffic_mod.data(mix)
    cfg = anneal_config(conf, seed)
    total = mix["total_moves"]
    device = str(dev)
    # warm-up: a short piece through the whole path (libraries built and
    # loaded, the device and its allocator warm)
    compressor.compress(data[:mix["warmup_bytes"]], cfg,
                        total_moves=mix["warmup_moves"], device=device)
    _sync(dev)
    results = []

    def capture(orig):
        def wrapper(*a, **kw):
            res = orig(*a, **kw)
            results.append(res)
            return res
        return wrapper

    def unit():
        blob = compressor.compress(data, cfg, total_moves=total,
                                   device=device)
        _sync(dev)
        return blob

    obs = {}
    out = {"device": {}, "obs": obs}
    watch = MoveWatch()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(compressor, "compress_block", capture))
        stack.enter_context(patched(engine, "anneal_iteration", watch.wrap))
        if trace:
            stack.enter_context(patched(engine, "make_context",
                                        _timed(obs, "make_context")))
            stack.enter_context(patched(emit_mod, "emit",
                                        _timed(obs, "emit")))
            stack.enter_context(patched(engine, "run_iters",
                                        _timed(obs, "run_iters")))
        out["setup_end"] = time.time()
        outs, elapsed = window.run_window(unit, seconds)
        out["jax"] = forbidden_modules()
        out["e2e"] = {
            "input_kib_per_s": window.rate(len(data) * len(outs) / 1024.0,
                                           elapsed),
            "out_bytes": len(outs[0])}
        obs["unit_wall_s"] = elapsed / len(outs)    # one file, unprofiled
        if trace:
            with profiled(obs, "file", 1, dev):
                outs.append(unit())
            _trace_outputs(out, obs)
    if dev.type == "cuda":
        out["device"]["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)

    nb = -(-len(data) // cfg.block_size)
    blocks = [data[i * cfg.block_size:(i + 1) * cfg.block_size]
              for i in range(nb)]
    per_block = max(1, total // nb)
    iters = max(1, per_block // (cfg.chains * cfg.proposals))
    want = window.moves(cfg.chains, cfg.proposals, iters)
    steps_gap = abs(watch.steps - iters * nb * len(outs))
    checks = {
        "outputs_differ": sum(o != outs[0] for o in outs),
        "chains_unmoved": watch.unmoved(),
        "moves_gap": max([abs(r.moves - want) for r in results]
                         + [steps_gap * want // iters])}
    if len(results) != nb * len(outs):
        checks["moves_gap"] = max(checks["moves_gap"], want)
    try:
        first = reference.container_streams(outs[0])
    except reference.StreamError:
        first = []
    costs = [_block_cost(r) for r in results[:nb]]
    checks.update(check.streams(blocks, first, costs))
    out["judged"] = (blocks, first, costs)
    out["checks"] = checks
    out["outputs"] = len(outs)
    return out


DRIVERS = {"anneal_block": anneal_block, "file": file}
