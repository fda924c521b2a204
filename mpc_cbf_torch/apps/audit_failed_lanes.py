"""Audit the f32 IPM's non-usable lanes against the exact oracle
(counterpart of ``scripts/audit_failed_lanes.py``).

The f32 IPM (``IPM_F32_ENTRY``) leaves a fraction of a percent of bench.py's
fov ensemble unusable. This classifies those lanes: the same dense QPs go to
the exact oracle (``ops/qp/oracle.py``, the CPLEX stand-in, on the host),
and its status per lane says whether they are infeasible random-geometry
QPs or a shortfall of the solver. The draw, the solve and the audit are
separate functions; ``run`` returns the counts and statuses.

Usage: python -m mpc_cbf_torch.apps.audit_failed_lanes [batch] [--device cuda]

It runs on the GPU (``--device cuda``, the default) and fails where there
is none; ``--device cpu`` asks for the CPU. The oracle runs on the host.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mpc_cbf_torch.types import QPBatch, State

#: neighbours of a lane (an 8-robot team), as bench.py's fov recipe
NEIGHBORS = 7


def draw(batch: int) -> dict:
    """The ensemble, drawn in the JAX script's order from numpy's
    default_rng(0): neighbour angles and ranges, then position, velocity
    and goal of each lane. float64 numpy arrays; nbr [B, N, 5] is [x, y,
    cov_xx, cov_xy, cov_yy]."""
    N = NEIGHBORS
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, (batch, N))
    rad = rng.uniform(1.0, 3.5, (batch, N))
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (batch, N, 3))
    nbr = np.concatenate([(rad * np.cos(ang))[..., None], (rad * np.sin(ang))[..., None], cov],
                         axis=-1)
    pos = rng.normal(0, 0.3, (batch, 3))
    vel = rng.normal(0, 0.5, (batch, 3))
    goals = rng.normal(0, 3.0, (batch, 3))
    return dict(nbr=nbr, pos=pos, vel=vel, goals=goals, mask=np.ones((batch, N), bool))


def build_controller(device, dtype: torch.dtype = torch.float32):
    """The script's FovIMPCCBF: 120° field of view, slack mode, 7 neighbours."""
    from mpc_cbf_torch.ops.cbf import FovCBF
    from mpc_cbf_torch.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams, FovIMPCCBF)

    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device=device, dtype=dtype)
    cbf = FovCBF(120.0 * np.pi / 180.0, 0.3, 6.0, mpc.v_min, mpc.v_max)
    return FovIMPCCBF(op, cbf, IMPCParams(slack_mode=True), NEIGHBORS,
                      box_half_extents=np.array([0.1, 0.1, 0.0]))


def lane_inputs(ctrl, draws: dict):
    """(current State, ref [B, 3 K], nbr, mask) on the controller's device
    and dtype."""
    op = ctrl.op
    B = draws["pos"].shape[0]
    ref = np.tile(draws["goals"][:, None, :], (1, op.mpc.k_hor, 1)).reshape(B, -1)
    return (State(pos=op.tensor(draws["pos"]), vel=op.tensor(draws["vel"])), op.tensor(ref),
            op.tensor(draws["nbr"]), torch.as_tensor(draws["mask"], device=op.device))


def _iteration0(ctrl, current: State):
    """pred_states [B, H, 6] (the current state at every step) and active_k
    [H] (step 0 only) of IMPC iteration 0."""
    H = ctrl.impc.cbf_horizon
    x = current.stacked
    pred = x[:, None, :].expand(x.shape[0], H, x.shape[-1])
    return pred, torch.arange(H, device=x.device) == 0


def solve(ctrl, current: State, ref, nbr, mask):
    """IMPC iteration 0's structured QPs through the f32 IPM; returns the
    IPMSolution (pri_res [B] against ctrl.USABLE_PRI_EPS says usable)."""
    from mpc_cbf_torch.ops.qp.ipm import IPM_F32_ENTRY, StructuredIPM

    pred, active = _iteration0(ctrl, current)
    q = ctrl.cost_vector(current, ref, nbr, mask)
    lb_s, ub_s = ctrl.shared_bounds(current)
    A_d, lb_d, ub_d = ctrl.dynamic_rows(current, nbr, mask, pred, active)
    P, A_s, eq_mask = ctrl.static_parts()
    ipm = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic, IPM_F32_ENTRY, device=ctrl.op.device)
    return ipm.solve(q, lb_s, ub_s, A_d, lb_d, ub_d)


def dense_qps(ctrl, current: State, ref, nbr, mask, lanes) -> QPBatch:
    """The dense QPs (``assemble``) of the given lanes, P expanded per lane."""
    idx = torch.as_tensor(np.asarray(lanes, np.int64), device=ref.device)
    cur = State(pos=current.pos[idx], vel=current.vel[idx])
    pred, active = _iteration0(ctrl, cur)
    qp = ctrl.assemble(cur, ref[idx], nbr[idx], mask[idx], pred, active)
    return qp._replace(P=qp.P.expand(len(idx), *qp.P.shape[-2:]))


def audit(qp: QPBatch) -> dict:
    """The exact oracle (host, float64) on a batch of dense QPs: status per
    lane (0 optimal, 1 max-iter, 2 numerical failure), the count of each,
    and, for lanes it solves, how far its own solution violates the rows."""
    from mpc_cbf_torch.ops.qp.oracle import solve_oracle_batch

    P, q, A, lb, ub = (x.detach().cpu().numpy().astype(np.float64) for x in qp)
    x, status = solve_oracle_batch(P, q, A, lb, ub)
    counts = zip(*np.unique(status, return_counts=True))
    out = {"status": status.tolist(), "status_counts": {int(s): int(c) for s, c in counts}}
    ok = status == 0
    if ok.any():
        ax = np.einsum("bmn,bn->bm", A[ok], x[ok])
        out["oracle_viol_max"] = float(np.maximum(np.maximum(lb[ok] - ax, ax - ub[ok]), 0).max())
    return out


def run(batch: int, device) -> dict:
    """Draw, solve and audit: {batch, usable, failed, failed_lanes,
    status_counts, status, [oracle_viol_max, pri_res_of_solvable]}."""
    ctrl = build_controller(device)
    args = lane_inputs(ctrl, draw(batch))
    pri = solve(ctrl, *args).pri_res.cpu().numpy()
    failed = np.nonzero(pri >= ctrl.USABLE_PRI_EPS)[0]
    out = {"batch": batch, "usable": float(1 - failed.size / batch), "failed": int(failed.size),
           "failed_lanes": failed.tolist()}
    if failed.size:
        out.update(audit(dense_qps(ctrl, *args, failed)))
        solvable = np.asarray(out["status"]) == 0
        out["pri_res_of_solvable"] = pri[failed][solvable].tolist()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batch", type=int, nargs="?", default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback: without a GPU, ask for cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    out = run(args.batch, device)
    print(f"batch={out['batch']} usable={out['usable']:.4f} failed={out['failed']}", flush=True)
    if out["failed"]:
        print(f"oracle status on failed lanes: {out['status_counts']}", flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "status"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
