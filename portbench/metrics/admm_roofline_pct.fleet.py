"""Per cent of the least time the card could take for a step's structured
ADMM work (``portbench.roofline``: the fastest known form, from the shapes,
phases and lanes alone) over the device time of every kernel launched
inside the solver's ``solve`` spans of the traced steps; the fleet cells that
report ``solves_per_s.admm``."""


def read(run):
    if run["kind"] != "fleet" or run["admm_bound_s"] is None:
        return None
    tr = run["trace"]
    ns = sum(e - s for _, s, e, _ in tr.kernels_in(tr.spans("solve")))
    if ns <= 0:
        return None
    return 100.0 * run["admm_bound_s"] / (ns * 1e-9 / run["traced_steps"])
