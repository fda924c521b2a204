"""Host ms a control step spends in the solver's ``solve`` (the structured
ADMM or the IPM), synchronised at each call's end;
the fleet cells that report ``solves_per_s.ipm``."""
from portbench.metrics._common import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "fleet", "solve")
