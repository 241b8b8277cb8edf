"""Profiling hooks (megalania_tpu/utils/profiling.py): a torch.profiler
trace, step timing that waits for the device, and the program's named
spans on the profiler's timeline."""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed work on the host and, where there is one, the
    CUDA device; on exit write `log_dir`/trace.json (chrome trace
    format).  Yields the torch.profiler.profile object, whose
    key_averages() are read after the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


@contextlib.contextmanager
def step_timer(name: str, sink=None):
    """Wall-time a device computation.  The caller stores its output in
    holder["result"] (a tensor, or a tuple such as an AnnealState); the
    timer synchronizes that tensor's CUDA device before it reads the
    clock, so the time covers the device work, not only its enqueue.
    The seconds go to holder["seconds"] and, as a record, to `sink`."""
    t0 = time.time()
    holder = {}
    try:
        yield holder
    finally:
        t = _first_tensor(holder.get("result"))
        if t is not None and t.is_cuda:
            torch.cuda.synchronize(t.device)
        dt = time.time() - t0
        if sink is not None:
            sink.log(name=name, seconds=round(dt, 4))
        holder["seconds"] = dt


_profiling = torch.autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named host range around the enclosed code on the torch profiler's
    timeline (`with span("iter.cost"): ...`), beside the kernels it
    launches.  With no profiler running it costs one check: it builds
    nothing and returns a shared no-op context.  Under a profiler the
    range is a plain host operation (RecordFunctionFast), not a user
    annotation like torch.profiler.record_function's, so the profiler
    puts no copy of it on the device timeline and it never counts as a
    device operation.  No span name holds `repair` or `propose`, the
    words by which the kernels are picked out of a device trace."""
    if _profiling():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN
