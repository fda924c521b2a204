"""Per cent of the least time the card could take for a step's K3 loop
(``portbench.roofline_k3``: the C form without the operand build, from the
shapes, phases and lanes of conn32.fleet's configuration and traffic) over
the device time of the ``cluster`` kernel's launches inside ``solve`` in the
traced steps. None where that kernel did not run."""
from portbench.metrics._cluster import device_ns_per_step, loop_bound_s


def read(run):
    ns = device_ns_per_step(run)
    return None if ns is None else 100.0 * loop_bound_s("conn32.fleet") / (ns * 1e-9)
