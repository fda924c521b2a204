"""The plain reference against the program's CPU route, a few lanes of
each configuration: the QP the program forms, the optimum its float64 IPM
finds, and the state its fly gives."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check
from portbench.drive import circle_rotate
from portbench.reference import qp as refqp
from portbench.reference.assembly import Reference

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def one_step(cfg, S=2, seed=0):
    """The program's solve inputs and answers of one control step of S
    scenarios, and the states they came from."""
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
    so, sf = circle_rotate(R, 4.0)
    pos = torch.tensor(so[None] + np.concatenate([rng.normal(0, 0.3, (S, R, 2)),
                                                  np.zeros((S, R, 1))], -1), dtype=torch.float32)
    vel = torch.tensor(rng.normal(0, 0.4, (S, R, 3)), dtype=torch.float32)
    goals = torch.tensor(np.broadcast_to(sf, (S, R, 3)).copy(), dtype=torch.float32)
    sim.control_step(State(pos=pos, vel=vel), goals)
    return sim, calls, pos, vel, goals


@pytest.mark.parametrize("name", ["conn8", "fov8"])
def test_assembly_and_optimum(name):
    cfg = config(name)
    sim, calls, pos, vel, goals = one_step(cfg)
    ref = Reference(cfg, CPU)
    R, N = ref.R, ref.N
    others = torch.tensor([[j for j in range(R) if j != i] for i in range(R)])
    x = torch.cat([pos, vel], -1).double()
    xl, nb, gl = x.reshape(-1, 6), x[:, others].reshape(-1, N, 6), goals.double().reshape(-1, 3)
    assert len(calls) == ref.impc_iter
    for it, (prog, sol) in enumerate(calls):
        pred = xl[:, None].expand(-1, ref.H, 6) if it == 0 else \
            ref.predicted(calls[0][1].z[:, :ref.n_dec].double())
        lane = ref.lane_qp(xl, gl, nb, pred, it)
        # float32 rounding of the program's float64-exact quantities
        assert float(check.qp_dev(ref, prog, lane).max()) < 1e-4
        # the reference's optimum is the program's float64 IPM's
        from mpc_cbf_torch.ops.qp.ipm import IPMConfig, StructuredIPM
        P, A_s, eq = sim.controller.static_parts()
        ipm = StructuredIPM(P, A_s, eq, sim.controller.m_dynamic, IPMConfig(iters=60), device=CPU)
        exact = ipm.solve(*[t.double() for t in prog])
        ne = ref.n_eq
        A = torch.cat([ref.tA_s.expand(xl.shape[0], -1, -1), lane.A_d], 1)[:, ne:]
        lb = torch.cat([lane.lb_s, lane.lb_d], 1)[:, ne:]
        ub = torch.cat([lane.ub_s, lane.ub_d], 1)[:, ne:]
        opt = refqp.solve(ref.tP, lane.q, ref.tA_s[:ne], lane.lb_s[:, :ne], A, lb, ub)
        both = opt.ok & exact.converged
        assert int(both.sum()) >= xl.shape[0] // 2
        # the IPM stops at its bars (mu 1e-10 relative) and the cost is flat
        # along some rows: the points agree to 1e-3
        assert float((opt.z - exact.z).abs().amax(1)[both].max()) < 1e-3


@pytest.mark.parametrize("name", ["conn8", "fov8"])
def test_fly(name):
    cfg = config(name)
    sim, calls, pos, vel, goals = one_step(cfg, seed=1)
    from mpc_cbf_torch.types import State

    ref = Reference(cfg, CPU)
    coeffs = calls[-1][1].z[:, :ref.n_dec].reshape(2, ref.R, -1).float()
    prev = State(pos=pos, vel=vel)
    fresh = torch.tensor([[True, False] * (ref.R // 2)] * 2)
    age = torch.arange(2 * ref.R).reshape(2, ref.R) % 20
    has = torch.tensor([[False] * ref.R, [True] * ref.R])
    object.__setattr__(sim, "noise_pos_std", 0.0)
    object.__setattr__(sim, "noise_vel_std", 0.0)
    st, new_age, new_has = sim.fly(coeffs, prev, fresh, None, age, has)
    p, v, a, h = ref.fly(coeffs.reshape(-1, ref.n_dec).double(), pos.reshape(-1, 3).double(),
                         fresh.reshape(-1), age.reshape(-1), has.reshape(-1))
    assert torch.allclose(st.pos.reshape(-1, 3).double(), p, atol=1e-5)
    assert torch.allclose(st.vel.reshape(-1, 3).double(), v, atol=1e-4)
    # ages past the curve's end all fly its end
    t_next = lambda x: torch.clamp_max((x.double() + 1) * ref.h, ref.curve.duration)
    assert torch.allclose(t_next(new_age.reshape(-1)), t_next(a))
    assert torch.equal(new_has.reshape(-1), h)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000001], dtype=torch.float64)
    got = check.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
