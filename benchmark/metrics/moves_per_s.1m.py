"""Moves per second of the traced run's own window in the 1 MiB cell, by
the host clock: moves_per_s.text's reader.  The cell's window is one
2,048-iteration sweep, and its end-to-end metric is out_bytes, so the
rate is read here without a bound."""
from benchlib import spec

read = spec.metric_reader("moves_per_s.text")
