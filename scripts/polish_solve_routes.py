"""Time the float64 KKT solves of the active-set polish on the card, route
by route (run from the repo root on a machine with a CUDA GPU):

    PYTHONPATH=. python3 scripts/polish_solve_routes.py [--lanes 8192]

On the IMPC-iteration-0 QPs of bench.py's fov and connectivity recipes
(numpy seed 0) it runs the float32 structured ADMM (the kernel) once, then
``polish_structured`` on its iterate with each way of solving the polish's
KKT systems, ``linsolve.plu_factor`` / ``plu_solve`` patched in:

- ``lu_solve``: torch.linalg.lu_factor_ex + torch.linalg.lu_solve (the
  port's route);
- ``triangular``: lu_factor_ex, lu_unpack and two solve_triangular;
- each of the two with torch's preferred linalg library set to cusolver
  (the batched LU then goes to cuBLAS' getrfBatched instead of MAGMA).

For each route: device ms of one polish call (CUDA events, median of 3
after a warm-up), its certified lanes (equal across routes, or the run
fails), and, from one call under torch.profiler, the kernel launches and
the cudaMalloc / cudaFree / cudaStreamSynchronize / cudaDeviceSynchronize /
cudaMemcpy calls the host made. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as smoke  # noqa: E402  (bench_problem, the card's name)
from mpc_cbf_torch.ops.qp import linsolve, polish  # noqa: E402

SYNC_CALLS = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync", "cudaMemcpy")


def lu_solve_route(fac, b):
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]


def triangular_route(fac, b):
    LU, piv = fac
    P, L, U = torch.lu_unpack(LU, piv)
    y = torch.linalg.solve_triangular(L, (P.mT @ b[..., None]), upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(U, y, upper=True)[..., 0]


@contextmanager
def route(solve, library):
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(library)
    saved = polish.plu_solve
    polish.plu_solve = solve
    try:
        yield
    finally:
        polish.plu_solve = saved
        torch.backends.cuda.preferred_linalg_library(before)


def iteration0(mode: str, lanes: int):
    ctrl, (cur, ref, nbr, mask) = smoke.bench_problem(mode, lanes)
    simpc = smoke.admm_stepper(ctrl, polish=True)
    H = ctrl.impc.cbf_horizon
    pred = cur.stacked[:, None, :].expand(lanes, H, 6)
    A_d, lb_d, ub_d = ctrl.dynamic_rows(cur, nbr, mask, pred, torch.arange(H, device=smoke.DEV) == 0)
    args = (ctrl.cost_vector(cur, ref, nbr, mask), *ctrl.shared_bounds(cur), A_d, lb_d, ub_d)
    return simpc.op_qp, args


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--lanes", type=int, default=8192)
    args = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from torch.profiler import ProfilerActivity, profile
    for mode in ("fov", "connectivity"):
        op, qp_args = iteration0(mode, args.lanes)
        entry = op.solve(*qp_args).z
        call = lambda: polish.polish_structured(op._P0, op._A_s0, *qp_args, entry,
                                                max_eq=op._n_eq, guards=op._guards)
        oks = {}
        for name, solve in (("lu_solve", lu_solve_route), ("triangular", triangular_route)):
            for library in ("default", "cusolver"):
                with route(solve, library):
                    res = call()
                    torch.cuda.synchronize()
                    times = []
                    for _ in range(3):
                        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        start.record()
                        res = call()
                        end.record()
                        torch.cuda.synchronize()
                        times.append(start.elapsed_time(end))
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        call()
                        torch.cuda.synchronize()
                oks[(name, library)] = res.ok.cpu()
                avgs = prof.key_averages()
                from torch.autograd import DeviceType
                launches = sum(e.count for e in avgs if e.device_type == DeviceType.CUDA)
                host = {k: sum(e.count for e in avgs if e.key == k) for k in SYNC_CALLS}
                print(f"{mode}, {args.lanes} lanes, {name} / {library}: polish "
                      f"{statistics.median(times):.2f} ms (device events, "
                      f"{min(times):.2f}..{max(times):.2f}), certified "
                      f"{float(res.ok.float().mean()):.4f}, {launches} kernel launches, host calls "
                      + ", ".join(f"{k} x{v}" for k, v in host.items() if v), flush=True)
        ref = oks[("lu_solve", "default")]
        for key, ok in oks.items():
            print(f"  {key}: certified flags differ from lu_solve/default on "
                  f"{int((ok != ref).sum())} lanes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
