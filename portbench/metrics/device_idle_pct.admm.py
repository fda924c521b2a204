"""Per cent of the traced whole steps in which no kernel, copy or set ran on
the device;
the fleet cells that report ``solves_per_s.admm``."""
from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run, "fleet")
