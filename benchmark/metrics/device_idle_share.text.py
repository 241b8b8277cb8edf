"""device_idle_share.anneal in the host-bound cell, where it moves
out_bytes (more iterations in the window) rather than a bounded rate:
the same reader, so that the arithmetic lives in one file."""
from benchlib import spec

read = spec.metric_reader("device_idle_share.anneal")
