"""Kernel launches a control step, counted in the profiler's trace;
the fleet cells that report ``solves_per_s.admm``."""
from portbench.metrics._common import launches_per_step


def read(run):
    return launches_per_step(run, "fleet")
