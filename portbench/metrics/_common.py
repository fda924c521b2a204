"""What the per-layer metrics read from a traced run.

``run`` holds: ``kind`` (the traffic's kind: fleet); ``steps`` and ``span_ms`` (the
host ms of each benchmark span summed over the window's steps, synchronised
at each span's ends); ``trace`` (``portbench.trace.Trace`` of the
``traced_steps`` whole steps profiled after the window, their spans not
synchronised) and ``window_ns``
(its start and end); ``admm_bound_s`` (``portbench.roofline``'s least time
for a step's ADMM work, None where the configuration runs no ADMM).
"""


def span_ms_per_step(run, kind: str, span: str):
    if run["kind"] != kind or span not in run["span_ms"] or not run["steps"]:
        return None
    return run["span_ms"][span] / run["steps"]


def idle_pct(run, kind: str):
    if run["kind"] != kind:
        return None
    lo, hi = run["window_ns"]
    busy = run["trace"].busy_ns(lo, hi)
    return None if busy <= 0 else 100.0 * (1.0 - busy / (hi - lo))


def launches_per_step(run, kind: str):
    if run["kind"] != kind:
        return None
    lo, hi = run["window_ns"]
    n = sum(1 for _, s, _, _ in run["trace"].kernels if lo <= s < hi)
    return None if n == 0 else n / run["traced_steps"]
