"""Per cent of the chip's peak that a whole step's structured ADMM work
would take (``portbench.roofline``'s least time) over the whole step's time
in the traced steps: it bounds ``admm_roofline_pct.fleet`` from the step's
side; the fleet cells that report ``solves_per_s.admm``."""


def read(run):
    if run["kind"] != "fleet" or run["admm_bound_s"] is None:
        return None
    lo, hi = run["window_ns"]
    return 100.0 * run["admm_bound_s"] / ((hi - lo) * 1e-9 / run["traced_steps"])
