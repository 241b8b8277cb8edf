"""Host ms of each engine.make_context call made inside
compressor.compress in the traced run (a timer the harness puts on the
module attribute), the mean over the calls."""
import statistics


def read(obs):
    calls = obs.get("timers", {}).get("make_context")
    return statistics.fmean(calls) * 1e3 if calls else None
