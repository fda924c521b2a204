"""Device ms a traced control step of the ``cluster`` K3 kernel's launches
(``reg_kernel`` or ``stream_kernel``) inside the solver's ``solve`` spans;
conn32.fleet, whose (67, 157, 62) lanes take that kernel. None where it did
not run."""
from portbench.metrics._cluster import device_ns_per_step


def read(run):
    ns = device_ns_per_step(run)
    return None if ns is None else ns * 1e-6
