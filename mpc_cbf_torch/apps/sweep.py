"""Batched scenario sweep, the replacement for ScaleScript.sh (counterpart
of ``mpc_cbf_tpu/apps/sweep.py``).

Where the reference launches independent simulator processes in a bash loop
(``experiments/bash/ScaleScript.sh:6-35``: num_robots 2-10 x FOV
{120,240,360} x 15 seeds in parallel via ``&``), here every seed of a grid
point is one lane of a batched scenario axis: the port's sims are
batch-first ([S, A, ...]), so all seeds of a cell run in lockstep in one
``sim.rollout`` and every solver call takes S x A lanes. (The JAX package
shards the same axis over a device mesh with ``sharded_rollout``; on one
device that is this rollout.)

The RSS-2025 grid axes (Statistics.py:24-35 panels):
  --sizes        team sizes (reference: 2..10)
  --fovs         FOV beta in degrees (reference: 120 240 360): applies to
                 the fov/single-shot/cbf-fov controllers
  --slack-decays slack_decay_rate values (the reference sweeps the decay of
                 the distance-ranked slack weights)

Usage:
  python -m mpc_cbf_torch.apps.sweep --base configs/base_config.json \\
      --sizes 2 4 6 8 10 --seeds 15 --controller fov \\
      --fovs 120 240 360 --slack-decays 0.1 \\
      --sim-runtime 6.0 --out /tmp/sweep.jsonl

It runs on the GPU (``--device cuda``, the default) and fails where there
is none; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch


def run_cell(cfg, controller, R, seeds, steps, solver_iters, start_noise=0.05,
             fov=None, slack_decay=None, radius=4.0, *, device):
    """One grid cell: (controller, R, fov, slack_decay) x seeds lanes.

    radius: circle radius for the rotate instance. The reference uses a
    FIXED radius 4 for every team size
    (``experiments/python/instances/generate_fov_instance.py:89``).
    Returns one row per seed, with the JAX package's keys."""
    from mpc_cbf_torch.types import State
    from mpc_cbf_torch.apps.run_sim import build_sim
    from mpc_cbf_torch.utils.instances import circle_rotate_instance
    from mpc_cbf_torch.utils import config as cfgmod
    from mpc_cbf_torch.utils.metrics import instance_success, instance_success_ref

    cfg = copy.deepcopy(cfg)
    if fov is not None:
        cfg.setdefault("fov_cbf_params", {})["beta"] = float(fov)
    if slack_decay is not None:
        cfg.setdefault("cbf_params", {})["slack_decay_rate"] = float(slack_decay)

    sim, _ = build_sim(cfg, controller, R, solver_iters, device=device)
    inst = circle_rotate_instance(R, radius=radius)
    so = np.asarray(inst["tasks"]["so"])
    sf = np.asarray(inst["tasks"]["sf"])

    rng = np.random.default_rng(0)
    so_b = so[None] + np.concatenate(
        [rng.normal(0, start_noise, (seeds, R, 2)), np.zeros((seeds, R, 1))], -1)
    tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                       device=device)
    init = State(pos=tensor(so_b), vel=tensor(np.zeros((seeds, R, 3))))
    goals = tensor(np.broadcast_to(sf, (seeds, R, 3)))

    t0 = time.time()
    res = sim.rollout(init, goals, steps,
                      generator=torch.Generator(device=device).manual_seed(0))
    traj = res.traj_pos.cpu().numpy()   # [S, T, R, 3]; the copy waits for the device
    wall = time.time() - t0
    solver_ok = res.success.float().mean(dim=tuple(range(1, res.success.dim()))).cpu().numpy()

    shape, shape_type = cfgmod.parse_collision_shape(cfg)
    coll = np.asarray(shape[:2]) if shape_type == "box" else shape
    rows = []
    for s in range(seeds):
        # dual scoring: strict (collision + goal reach) AND the reference's
        # collision-only semantics (its goal-miss return is commented out,
        # collision_check.py:56-59)
        tr = traj[s].transpose(1, 0, 2)
        ok, makespan = instance_success(
            tr, sf, radius=1.0, collision_shape=coll, shape_type=shape_type)
        ok_ref, makespan_ref = instance_success_ref(
            tr, sf, radius=1.0, collision_shape=coll, shape_type=shape_type)
        # per-seed diagnostics: the failure cause (collision, goal miss,
        # solver stall) is readable from the row
        xy = tr[..., :2]                                   # [R, T, 2]
        dmat = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
        iu = np.triu_indices(R, k=1)
        min_sep = float(dmat[iu].min()) if R > 1 else float("inf")
        final_goal_dist = float(np.linalg.norm(xy[:, -1] - sf[:, :2], axis=-1).max())
        rows.append({
            "controller": controller, "num_robots": R, "seed": s,
            "fov": float(fov) if fov is not None else None,
            "slack_decay": float(slack_decay) if slack_decay is not None else None,
            "success": bool(ok), "makespan": makespan,
            "success_ref": bool(ok_ref), "makespan_ref": makespan_ref,
            "min_separation": round(min_sep, 3),
            "final_goal_dist_max": round(final_goal_dist, 3),
            "solver_success_rate": float(solver_ok[s]),
            "wall_s_batch": round(wall, 2), "steps": steps,
        })
    return rows


# the JAX package's alias of run_cell (mpc_cbf_tpu/apps/sweep.py:115-116), its pre-grid name
run_size = run_cell


def main(argv=None) -> int:
    from mpc_cbf_torch.utils import config as cfgmod

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", required=True)
    p.add_argument("--sizes", type=int, nargs="+", default=[2, 4, 6, 8, 10])
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--controller", default="connectivity")
    p.add_argument("--fovs", type=float, nargs="+", default=[None],
                   help="FOV beta values in degrees (e.g. 120 240 360)")
    p.add_argument("--slack-decays", type=float, nargs="+", default=[None],
                   help="slack_decay_rate values (e.g. 0.1 0.3)")
    p.add_argument("--radius", type=float, default=4.0,
                   help="instance circle radius (reference fixes 4.0: "
                        "generate_fov_instance.py:89)")
    p.add_argument("--sim-runtime", type=float, default=6.0)
    p.add_argument("--solver-iters", type=int, default=200)
    p.add_argument("--out", default="sweep.jsonl")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback: without a GPU, ask for cpu)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")

    cfg = cfgmod.load_config(args.base)
    steps = int(round(args.sim_runtime / cfgmod.parse_mpc_params(cfg).h))
    all_rows = []
    for R in args.sizes:
        for fov in args.fovs:
            for decay in args.slack_decays:
                rows = run_cell(cfg, args.controller, R, args.seeds, steps,
                                args.solver_iters, fov=fov, slack_decay=decay,
                                radius=args.radius, device=device)
                all_rows.extend(rows)
                ok = sum(r["success"] for r in rows)
                tag = "".join([f" fov={fov:g}" if fov is not None else "",
                               f" decay={decay:g}" if decay is not None else ""])
                print(f"R={R}{tag}: {ok}/{len(rows)} success, "
                      f"batch wall {rows[0]['wall_s_batch']}s")

    with open(args.out, "w") as f:
        for r in all_rows:
            f.write(json.dumps(r) + "\n")
    print(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
