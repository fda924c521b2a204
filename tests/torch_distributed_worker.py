"""Worker process for test_torch_parallel.py's two-process test: one
torch.distributed process (gloo, CPU) of an N-process group. It makes its
own scenarios, assembles the global batch with host_scenarios_to_global,
runs the rows of the global mesh it owns through sharded_rollout, and dumps
the gathered trajectories [S_global, T, A, 3] to an npz for the parent.
Imports torch and mpc_cbf_torch only.

Usage: python torch_distributed_worker.py <rank> <world> <port> <out.npz>
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpc_cbf_torch.types import State  # noqa: E402
from mpc_cbf_torch.ops.cbf import ConnectivityCBF  # noqa: E402
from mpc_cbf_torch.ops.qp import ADMMConfig  # noqa: E402
from mpc_cbf_torch.controllers import (  # noqa: E402
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams, ConnectivityIMPCCBF)
from mpc_cbf_torch.parallel import MultiAgentSim, sharded_rollout  # noqa: E402
from mpc_cbf_torch.parallel.distributed import (  # noqa: E402
    global_mesh, host_scenarios_to_global, init_distributed)

S_PER_PROCESS = 4
STEPS = 5


def scenarios(lo, hi):
    """tests/distributed_worker.py's scenario set, indexed globally."""
    starts, goals = [], []
    for s in range(lo, hi):
        off = 0.1 * s
        starts.append([[-1.5, off, 0.0], [1.5, -off, 0.0]])
        goals.append([[1.5, 0.0, 0.0], [-1.5, 0.0, 0.0]])
    return np.asarray(starts, np.float64), np.asarray(goals, np.float64)


def main():
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    init_distributed(f"tcp://localhost:{port}", world, rank)
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device="cpu", dtype=torch.float64)
    ctrl = ConnectivityIMPCCBF(op, ConnectivityCBF(0.8, 4.0, mpc.v_min, mpc.v_max),
                               IMPCParams(), 1, solver=ADMMConfig(iters=100))
    sim = MultiAgentSim(ctrl, 2)
    mesh = global_mesh(agent=1)
    lo = rank * S_PER_PROCESS
    starts, goals = (torch.from_numpy(a) for a in scenarios(lo, lo + S_PER_PROCESS))
    init_g, goals_g = host_scenarios_to_global(
        mesh, (State(starts, torch.zeros_like(starts)), goals))
    res = sharded_rollout(sim, mesh, init_g, goals_g, STEPS)
    np.savez(out, traj_pos=res.traj_pos.numpy(), starts=init_g.pos.numpy(),
             mesh_rows=np.asarray(mesh.devices.shape))
    torch.distributed.destroy_process_group()
    print(f"worker {rank}: wrote {out}", flush=True)


if __name__ == "__main__":
    main()
