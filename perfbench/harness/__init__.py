"""The benchmark's harness: manifest, traffic, weights, the driven service,
the profiler slice, the frozen FLOP and roofline arithmetic, and the check
of the served output against ``perfbench/reference``."""
