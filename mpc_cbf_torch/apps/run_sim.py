"""Config-driven simulation runner, the app layer (counterpart of
``mpc_cbf_tpu/apps/run_sim.py``).

Reference parity: the example mains
(``mpc_cbf/examples/connectivity/MPCCBFFormationControl_example.cpp:18-233``,
``mpc_cbf/examples/fov/BezierIMPCCBFPFXYYaw_example.cpp``) and the
run_mpccbf.sh pipeline: load base+task config, build the controller, run the
closed-loop sim, write a ``states.json`` in the reference's schema
(states["robots"][i]["states"]), and score with the collision/goal metrics.

Usage:
  python -m mpc_cbf_torch.apps.run_sim --base configs/base_config.json \
      --task configs/tasks_4r_rotate.json --controller connectivity \
      --sim-runtime 6.0 --out /tmp/states.json

It runs on the GPU (``--device cuda``, the default) and fails where there
is none; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


CONTROLLERS = (
    "connectivity",       # ConnectivityIMPCCBF  (MPCCBFFormationControl_example)
    "fov",                # FovIMPCCBF           (BezierIMPCCBFPFXYYaw_example)
    "single-shot",        # BezierMPCCBF         (BezierMPCCBFXYYaw_example)
    "mpc",                # BezierMPC, no CBF    (BezierMPCXYYaw_example)
    "cbf-connectivity",   # ConnectivityControl  (CBFFormationControl_example)
    "cbf-fov",            # FovControl           (CBFControl_example, --pf for
                          #                       the particle-filter estimator)
)

#: the controllers StructuredIMPC flies, which alone have a certified pipeline
STRUCTURED_IMPC = ("connectivity", "fov", "single-shot")


def _fov_cbf(cfg: dict, mpc):
    from mpc_cbf_torch.ops.cbf import FovCBF

    f = cfg.get("fov_cbf_params", {})
    beta = float(f.get("beta", 120.0)) * np.pi / 180.0
    return FovCBF(beta, float(f.get("Ds", 0.3)), float(f.get("Rs", 4.0)),
                  mpc.v_min, mpc.v_max)


def build_sim(cfg: dict, controller: str, num_robots: int, solver_iters: int,
              use_pf: bool = False, enable_connectivity: bool = False,
              certified: bool = False, *, device, dtype: torch.dtype = torch.float32):
    from mpc_cbf_torch.ops.cbf import ConnectivityCBF
    from mpc_cbf_torch.ops.qp import ADMMConfig
    from mpc_cbf_torch.controllers import (
        BezierMPC, BezierMPCOperator, BezierMPCCBF,
        ConnectivityIMPCCBF, FovIMPCCBF,
        FovCBFController, ConnectivityCBFController,
    )
    from mpc_cbf_torch.parallel import MultiAgentSim, BezierMPCSim, CBFOnlySim
    from mpc_cbf_torch.utils import config as cfgmod

    if controller not in CONTROLLERS:
        raise ValueError(f"unknown controller {controller!r} ({'|'.join(CONTROLLERS)})")
    if certified and controller not in STRUCTURED_IMPC:
        # the JAX package's runner silently flies these uncertified
        raise ValueError(
            f"--certified: the {controller!r} controller has no certified pipeline "
            f"(only {'|'.join(STRUCTURED_IMPC)} run the hybrid IPM)")

    bez = cfgmod.parse_bezier_params(cfg)
    mpc = cfgmod.parse_mpc_params(cfg)
    impc = cfgmod.parse_impc_params(cfg)
    pos_std, vel_std = cfgmod.parse_noise(cfg)
    solver = ADMMConfig(iters=solver_iters)
    shape, _ = cfgmod.parse_collision_shape(cfg)
    half = np.asarray(shape, dtype=float) / 2.0 if np.ndim(shape) else np.zeros(3)

    if controller in ("connectivity", "fov", "single-shot", "mpc"):
        op = BezierMPCOperator(bez, mpc, dim=3, device=device, dtype=dtype)
        if controller == "connectivity":
            d_min, d_max = cfgmod.parse_cbf_distances(cfg)
            cbf = ConnectivityCBF(d_min, d_max, mpc.v_min, mpc.v_max)
            ctrl = ConnectivityIMPCCBF(op, cbf, impc, num_robots - 1, solver=solver,
                                       enable_connectivity=enable_connectivity)
        elif controller == "fov":
            ctrl = FovIMPCCBF(op, _fov_cbf(cfg, mpc), impc, num_robots - 1,
                              box_half_extents=half, solver=solver)
        elif controller == "single-shot":
            ctrl = BezierMPCCBF(op, _fov_cbf(cfg, mpc), num_robots - 1,
                                solver=solver)
        else:  # mpc
            ctrl = BezierMPC(op, num_robots - 1, box_half_extents=half,
                             solver=solver)
            return BezierMPCSim(ctrl, num_robots, noise_pos_std=pos_std,
                                noise_vel_std=vel_std), mpc
        # one structured solve per step for the whole agent batch. fov runs
        # the production solver (the f32 Mehrotra IPM: interior iterates,
        # far more usable lanes than the ADMM); the other controllers keep
        # the ADMM, whose loop is the CUDA kernel. --certified flies the
        # accuracy-certified pipeline (HYBRID_PROD: f32 entry + calibrated
        # f64 tail).
        solver_cfg = None
        if certified:
            from mpc_cbf_torch.ops.qp.ipm import HYBRID_PROD
            solver_cfg = HYBRID_PROD
        elif controller == "fov":
            from mpc_cbf_torch.ops.qp.ipm import IPM_F32_ENTRY
            solver_cfg = IPM_F32_ENTRY
        return MultiAgentSim(ctrl, num_robots, noise_pos_std=pos_std,
                             noise_vel_std=vel_std, structured=True,
                             solver_cfg=solver_cfg), mpc

    # single-step controllers read the same slack knobs as the reference
    # examples (CBFFormationControl_example.cpp:94-96,165)
    slack = dict(slack_mode=impc.slack_mode, slack_cost=impc.slack_cost,
                 slack_decay_rate=impc.slack_decay_rate)
    if controller == "cbf-fov":
        ctrl = FovCBFController(_fov_cbf(cfg, mpc), num_robots - 1,
                                u_min=mpc.a_min, u_max=mpc.a_max,
                                solver=solver, **slack)
        return CBFOnlySim(ctrl, num_robots, dt=mpc.h, use_pf=use_pf), mpc
    d_min, d_max = cfgmod.parse_cbf_distances(cfg)
    cbf = ConnectivityCBF(d_min, d_max, mpc.v_min, mpc.v_max)
    ctrl = ConnectivityCBFController(cbf, num_robots, solver=solver, **slack)
    return CBFOnlySim(ctrl, num_robots, dt=mpc.h), mpc


def main(argv=None) -> int:
    from mpc_cbf_torch.types import State
    from mpc_cbf_torch.utils import config as cfgmod
    from mpc_cbf_torch.utils.metrics import instance_success

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--controller", default="connectivity", choices=list(CONTROLLERS))
    p.add_argument("--pf", action="store_true",
                   help="cbf-fov only: estimate neighbors with per-pair "
                        "particle filters (FOV negative-information update)")
    p.add_argument("--sim-runtime", type=float, default=6.0)
    p.add_argument("--solver-iters", type=int, default=200)
    p.add_argument("--enable-connectivity", action="store_true",
                   help="turn on the MPC-level lambda2/CLF constraint family "
                        "(the block the reference ships commented out, "
                        "ConnectivityIMPCCBF.cpp:144-157)")
    p.add_argument("--certified", action="store_true",
                   help="IMPC controllers: fly the accuracy-certified "
                        "pipeline (HYBRID_PROD f32 entry + calibrated f64 "
                        "tail; every certified curve <1e-3 vs the exact "
                        "optimum). Refused for the other controllers.")
    p.add_argument("--out", default="states.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback: without a GPU, ask for cpu)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")

    cfg = cfgmod.load_config(args.base, args.task)
    so, sf = cfgmod.parse_tasks(cfg)
    R = so.shape[0]
    sim, mpc = build_sim(cfg, args.controller, R, args.solver_iters, use_pf=args.pf,
                         enable_connectivity=args.enable_connectivity,
                         certified=args.certified, device=device)

    steps = int(round(args.sim_runtime / mpc.h))
    tensor = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    init = State(pos=tensor(so), vel=tensor(np.zeros((R, 3))))
    goals = tensor(sf)

    t0 = time.time()
    res = sim.rollout(init, goals, steps,
                      generator=torch.Generator(device=device).manual_seed(args.seed))
    traj = res.traj_pos.cpu().numpy()   # [T, R, 3]; the copy waits for the device
    vels = res.traj_vel.cpu().numpy()
    wall = time.time() - t0

    # states.json in the reference's schema
    out = {"dt": mpc.h, "Ts": mpc.Ts, "robots": {}}
    for i in range(R):
        rec = {
            "states": np.concatenate([traj[:, i], vels[:, i]], axis=-1).tolist(),
            "goal": sf[i].tolist(),
        }
        # estimator logs, reference schema (states["robots"][i]
        # ["estimates_mean"|"estimates_cov"],
        # BezierIMPCCBFPFXYYaw_example.cpp:204-280)
        if hasattr(res, "est_mean"):
            rec["estimates_mean"] = res.est_mean[:, i].cpu().numpy().tolist()
            rec["estimates_cov"] = res.est_cov[:, i].cpu().numpy().tolist()
        out["robots"][str(i)] = rec
    with open(args.out, "w") as f:
        json.dump(out, f)

    shape, shape_type = cfgmod.parse_collision_shape(cfg)
    coll = (np.asarray(shape[:2]) if shape_type == "box" else shape)
    ok, makespan = instance_success(
        traj.transpose(1, 0, 2), sf, radius=1.0,
        collision_shape=coll, shape_type=shape_type,
    )
    summary = {
        "controller": args.controller, "num_robots": R, "steps": steps,
        "success": bool(ok), "makespan": makespan, "wall_s": round(wall, 2),
        "solver_success_rate": float(res.success.float().mean()),
        "out": args.out,
    }
    # fraction of flown curves carrying the <1e-3 accuracy certificate
    # (certifying solvers only, see SimResult.certified)
    if args.certified and getattr(res, "certified", None) is not None:
        summary["certified_rate"] = float(res.certified.float().mean())
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
