"""conn32, the 32-robot connectivity teams, on the CPU: the plain reference
against the program's CPU route (the QP it forms, the optimum of its float64
IPM, the state its fly gives) on 2 scenarios of 32 robots on the traffic's
ring, and whole tiny runs of the harness at conn32.fleet's configuration and
traffic kind (its last line, and ``correct`` false with the program broken)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.drive import circle_rotate
from portbench.reference import qp as refqp
from portbench.reference.assembly import Reference
from portbench.tests import test_portbench_reference as reference_tests
from portbench.tests import test_portbench_run as runs

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "conn32.fleet"
RADIUS = json.loads((ROOT / "portbench" / "workloads" / "fleet1024x20.json").read_text())["radius"]


def one_step(cfg, S=2, seed=0):
    """The program's solve inputs and answers of one control step of S
    scenarios on the traffic's ring (noise 0.3 m, random velocities), and the
    states they came from."""
    import copy

    from mpc_cbf_torch.apps.run_sim import build_sim
    from mpc_cbf_torch.types import State

    R = cfg["robots"]
    sim, _ = build_sim(copy.deepcopy(cfg["base"]), cfg["controller"], R, cfg["solver"]["iters"],
                       device=CPU)
    simpc = sim._structured_impc()
    calls = []
    solve = simpc.op_qp.solve

    def spy(*a, **k):
        out = solve(*a, **k)
        calls.append((a[:6], out))
        return out
    simpc.op_qp.solve = spy
    rng = np.random.default_rng(seed)
    so, sf = circle_rotate(R, RADIUS)
    pos = torch.tensor(so[None] + np.concatenate([rng.normal(0, 0.3, (S, R, 2)),
                                                  np.zeros((S, R, 1))], -1), dtype=torch.float32)
    vel = torch.tensor(rng.normal(0, 0.4, (S, R, 3)), dtype=torch.float32)
    goals = torch.tensor(np.broadcast_to(sf, (S, R, 3)).copy(), dtype=torch.float32)
    sim.control_step(State(pos=pos, vel=vel), goals)
    return sim, calls, pos, vel, goals


def test_lane_shape():
    """A lane of conn32 is (35 + R, 125 + R, 2R - 2) = (67, 157, 62): the 36
    curve coefficients and 31 slacks, the shared rows, two rows a neighbour."""
    ref = Reference(reference_tests.config("conn32"), CPU)
    assert (ref.n, ref.m_s, ref.m_d, ref.n_dec) == (67, 157, 62, 36)


def test_assembly_and_optimum():
    """The QP the program forms is the reference's, and on the lanes where the
    program's float64 IPM converges its curve is the reference's optimum.

    The slack columns of the farthest neighbours cost slack_cost * decay**rank,
    down to 5e4 * 0.1**30: the cost is flat along them to the solvers'
    precision, their values are not determined, and the reference's exact step
    meets a singular KKT matrix on most lanes (conn8's and fov8's seven ranks
    cost at least 0.05). So the reference's Mehrotra iterate, run to 200
    iterations, stands for the optimum, and the curve, which is what flies, is
    compared, to the 1e-3 of conn8's and fov8's whole points."""
    cfg = reference_tests.config("conn32")
    sim, calls, pos, vel, goals = one_step(cfg)
    ref = Reference(cfg, CPU)
    R, N = ref.R, ref.N
    others = torch.tensor([[j for j in range(R) if j != i] for i in range(R)])
    x = torch.cat([pos, vel], -1).double()
    xl, nb, gl = x.reshape(-1, 6), x[:, others].reshape(-1, N, 6), goals.double().reshape(-1, 3)
    assert len(calls) == ref.impc_iter
    assert ref.decay ** (N - 1) * ref.slack_cost < 1e-20
    from mpc_cbf_torch.ops.qp.ipm import IPMConfig, StructuredIPM
    P, A_s, eq = sim.controller.static_parts()
    ipm = StructuredIPM(P, A_s, eq, sim.controller.m_dynamic, IPMConfig(iters=60), device=CPU)
    for it, (prog, sol) in enumerate(calls):
        pred = xl[:, None].expand(-1, ref.H, 6) if it == 0 else \
            ref.predicted(calls[0][1].z[:, :ref.n_dec].double())
        lane = ref.lane_qp(xl, gl, nb, pred, it)
        # float32 rounding of the program's float64-exact quantities
        assert float(check.qp_dev(ref, prog, lane).max()) < 1e-4
        exact = ipm.solve(*[t.double() for t in prog])
        ne = ref.n_eq
        A = torch.cat([ref.tA_s.expand(xl.shape[0], -1, -1), lane.A_d], 1)[:, ne:]
        lb = torch.cat([lane.lb_s, lane.lb_d], 1)[:, ne:]
        ub = torch.cat([lane.ub_s, lane.ub_d], 1)[:, ne:]
        opt = refqp.solve(ref.tP, lane.q, ref.tA_s[:ne], lane.lb_s[:, :ne], A, lb, ub, iters=200)
        assert int(exact.converged.sum()) >= xl.shape[0] // 2
        gap = (opt.z - exact.z)[:, :ref.n_dec].abs().amax(1)
        assert float(gap[exact.converged].max()) < 1e-3


def test_fly():
    reference_tests.test_fly("conn32")


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tmp_path, capsys, trace):
    runs.test_last_line(tmp_path, capsys, CELL, trace)


@pytest.mark.parametrize("fault", [runs.fly_unchanged, runs.answer(runs.half_left_out),
                                   runs.answer(runs.altered), runs.q_dropped, runs.stops_early],
                         ids=["state_unchanged", "half_the_batch_left_out", "answer_altered",
                              "cost_dropped", "admm_stops_early"])
def test_fault_is_caught(tmp_path, capsys, fault):
    runs.test_fault_is_caught(tmp_path, capsys, CELL, fault)
