"""Host ms a control step spends in the program's assembly (``cost_vector``,
``shared_bounds``, ``dynamic_rows``), synchronised at each call's end;
the fleet cells that report ``solves_per_s.admm``."""
from portbench.metrics._common import span_ms_per_step


def read(run):
    return span_ms_per_step(run, "fleet", "assembly")
