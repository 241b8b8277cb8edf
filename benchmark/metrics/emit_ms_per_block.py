"""Host ms of each runtime.emit.emit call made inside compressor.compress
in the traced run (a timer on the module attribute), the mean."""
import statistics


def read(obs):
    calls = obs.get("timers", {}).get("emit")
    return statistics.fmean(calls) * 1e3 if calls else None
