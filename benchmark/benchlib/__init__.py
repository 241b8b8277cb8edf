"""The benchmark's own library: the specification and its files, the
traffic generator, the window arithmetic, the reduction of device
traces, the roofline count and table of peaks, the plain reference and
the comparison that decides `correct`.  Only `cells` imports the
program under test."""
