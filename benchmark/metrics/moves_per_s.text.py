"""Moves per second of the traced run's own window, by the host clock
(all moves of the window over all its seconds), as a per-layer reading
without a bound: in the host-bound cell the host's speed spreads it too
widely to bound (PERF.md)."""


def read(obs):
    return obs.get("window_moves_per_s")
