"""host_ms_per_iter in the four-card cell, where it moves
moves_per_s.4gpu: the same reader, over rank 0's profiled iterations.
There `iter.best` holds the exchange's host read (parallel/mesh.py), so
the host's spans take in its wait for the card's iteration and for the
slowest rank."""
from benchlib import spec

read = spec.metric_reader("host_ms_per_iter.text")
