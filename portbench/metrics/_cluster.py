"""What the ``cluster`` K3 kernel's metrics read: its device time in a
traced run, and the least time of its loop at its cell's shapes."""

import json
import re
from pathlib import Path

#: the cluster kernel's two layouts as the profiler names them:
#: ``void (anonymous namespace)::reg_kernel<16, 20, 3>(...)`` and
#: ``stream_kernel`` (csrc/structured_admm_cluster.cu)
KERNEL = re.compile(r"\(anonymous namespace\)::(reg|stream)_kernel\b")
ROOT = Path(__file__).resolve().parents[2]


def device_ns_per_step(run):
    """Device ns a traced step of the cluster kernel's launches inside the
    solver's ``solve`` spans; None where none ran."""
    if run["kind"] != "fleet":
        return None
    tr = run["trace"]
    ns = sum(e - s for name, s, e, _ in tr.kernels_in(tr.spans("solve")) if KERNEL.search(name))
    return None if ns <= 0 else ns / run["traced_steps"]


def loop_bound_s(cell: str) -> float:
    """``portbench.roofline_k3``'s least time for a step's K3 loop at the
    cell's shapes, phases and lanes, read from its configuration and traffic."""
    import torch

    from portbench.reference.assembly import Reference
    from portbench.roofline_k3 import k3_bound_s

    here = ROOT / "portbench"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = json.loads((here / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((here / "workloads" / f"{w['traffic']}.json").read_text())
    ref = Reference(cfg, torch.device("cpu"))
    lanes = int(traffic["scenarios"]) * int(cfg["robots"])
    return k3_bound_s(lanes, ref.n, ref.m_s, ref.m_d, list(cfg["solver"]["phases"]) * ref.impc_iter)
