"""The structured closed loop of mpc_cbf_torch (parallel/sim.py) against
the JAX package's MultiAgentSim, and the numpy/geometry helpers it uses.

Rollouts run with zero noise (jax.random and torch.Generator draw
different numbers from one seed); the port runs both scenarios as one
batch [S, A, ...], the JAX package one rollout per scenario. The
per-step solver success must be equal; trajectories agree to atol 1e-4
(measured max |Δ| in each test's docstring). Noisy rollouts are checked
for determinism under one seed.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.parallel import MultiAgentSim as JMultiAgentSim
from mpc_cbf_tpu.ops.geometry import (
    convert_to_closest_yaw as j_closest_yaw, convert_yaw_in_range as j_yaw_in_range)
from mpc_cbf_tpu.ops.qp.ipm import IPMConfig as JIPMConfig
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
from mpc_cbf_tpu.utils import instances as j_instances
from mpc_cbf_tpu.utils import metrics as j_metrics

from mpc_cbf_torch.controllers import StructuredIMPC
from mpc_cbf_torch.ops.controls import add_random_noise
from mpc_cbf_torch.ops.geometry import convert_to_closest_yaw, convert_yaw_in_range
from mpc_cbf_torch.ops.qp import IPM_F32_ENTRY, IPMConfig, StructuredConfig
from mpc_cbf_torch.parallel import MultiAgentSim
from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils import convert, instances, metrics

import torch_parity_cases as cases

CPU = torch.device("cpu")
F64 = torch.float64
STEPS = 5


def _controllers(mode, num_agents):
    """(JAX controller, port controller) for an A-robot team, float64."""
    from mpc_cbf_tpu.ops.cbf import ConnectivityCBF as JConnCBF, FovCBF as JFovCBF
    from mpc_cbf_tpu.controllers import (
        BezierParams as JBP, MPCParams as JMP, BezierMPCOperator as JOp,
        IMPCParams as JIP, ConnectivityIMPCCBF as JConn, FovIMPCCBF as JFov)
    from mpc_cbf_torch.ops.cbf import ConnectivityCBF, FovCBF
    from mpc_cbf_torch.controllers import (
        BezierParams, MPCParams, BezierMPCOperator, IMPCParams,
        ConnectivityIMPCCBF, FovIMPCCBF)

    N = num_agents - 1
    jm, m = JMP(), MPCParams()
    op_j = JOp(JBP(), jm, dim=3)
    op_t = BezierMPCOperator(BezierParams(), m, dim=3, device=CPU, dtype=F64)
    vj = (jnp.asarray(jm.v_min), jnp.asarray(jm.v_max))
    if mode == "fov":
        ctrl_j = JFov(op_j, JFovCBF(cases.FOV_BETA, 0.3, 6.0, *vj),
                      JIP(slack_mode=True), N, box_half_extents=cases.BOX)
        ctrl_t = FovIMPCCBF(op_t, FovCBF(cases.FOV_BETA, 0.3, 6.0, m.v_min, m.v_max),
                            IMPCParams(slack_mode=True), N, box_half_extents=cases.BOX)
    else:
        ctrl_j = JConn(op_j, JConnCBF(1.0, 4.0, *vj), JIP(), N)
        ctrl_t = ConnectivityIMPCCBF(op_t, ConnectivityCBF(1.0, 4.0, m.v_min, m.v_max),
                                     IMPCParams(), N)
    return ctrl_j, ctrl_t


def _scenarios(num_agents, box):
    """Two random instances [2, A, 3] (starts, goals), float64."""
    so, sf = [], []
    for seed in range(2):
        tasks = instances.random_instance(num_agents, box=box, seed=seed)["tasks"]
        so.append(tasks["so"])
        sf.append(tasks["sf"])
    return np.asarray(so), np.asarray(sf)


@functools.lru_cache(maxsize=None)
def _rollouts(mode):
    """(port SimResult over [2, A], [JAX SimResult per scenario])."""
    if mode == "fov":
        A, box, cfg_j, cfg_t = 3, 3.0, JIPMConfig(), IPMConfig()
    else:
        A, box = 4, 2.5
        cfg_j, cfg_t = JStructuredConfig(iters=60, use_pallas=False), StructuredConfig(iters=60)
    ctrl_j, ctrl_t = _controllers(mode, A)
    so, sf = _scenarios(A, box)
    sim_j = JMultiAgentSim(ctrl_j, A, structured=True, solver_cfg=cfg_j)
    sim_t = MultiAgentSim(ctrl_t, A, structured=True, solver_cfg=cfg_t)
    if mode == "connectivity":
        # the JAX ADMM operator holds its constants in float32 whatever the
        # input dtype: the port takes them over so both run the same f64 loop
        op_j = sim_j._structured_impc().op_qp
        convert.set_structured_constants(
            sim_t._structured_impc().op_qp, D=np.asarray(op_j.D), E_s=np.asarray(op_j.E_s),
            gamma=op_j.gamma, Pb=np.asarray(op_j.Pb), A_sb=np.asarray(op_j.A_sb),
            phases=[(n, np.asarray(M), np.asarray(r), rd) for n, M, r, rd in op_j.phases])
    zeros = np.zeros_like(so)
    res_t = sim_t.rollout(State(torch.from_numpy(so), torch.from_numpy(zeros)),
                          torch.from_numpy(sf), STEPS)
    res_j = [sim_j.rollout(JState(pos=jnp.asarray(so[s]), vel=jnp.asarray(zeros[s])),
                           jnp.asarray(sf[s]), STEPS) for s in range(2)]
    return res_t, res_j


@pytest.mark.parametrize("mode", ["fov", "connectivity"])
def test_rollout_matches_jax_per_scenario(mode):
    """fov: 3 robots, f64 IPMConfig(), the sensing mask active (random
    arenas of ±3 m; scenario 0 starts with one pair beyond Rs).
    connectivity: 4 robots, f64 StructuredConfig(iters=60) with the ADMM
    dual carry. Measured on the CPU, max |Δ| of positions / velocities:
    2.0e-8 / 9.9e-8 (fov) and 2.7e-14 / 4.9e-14 (connectivity); bar 1e-4."""
    res_t, res_j = _rollouts(mode)
    A = res_t.traj_pos.shape[-2]
    assert res_t.traj_pos.shape == (2, STEPS, A, 3)
    assert res_t.success.shape == res_t.certified.shape == (2, STEPS, A)
    assert res_t.coeffs.shape == (2, A, 36)
    for s in range(2):
        np.testing.assert_array_equal(res_t.success[s].numpy(), np.asarray(res_j[s].success))
        np.testing.assert_array_equal(res_t.certified[s].numpy(),
                                      np.asarray(res_j[s].certified))
        np.testing.assert_allclose(res_t.traj_pos[s].numpy(), np.asarray(res_j[s].traj_pos),
                                   atol=1e-4)
        np.testing.assert_allclose(res_t.traj_vel[s].numpy(), np.asarray(res_j[s].traj_vel),
                                   atol=1e-4)
        np.testing.assert_allclose(res_t.coeffs[s].numpy(), np.asarray(res_j[s].coeffs),
                                   atol=1e-4)
    assert res_t.success.float().mean() > 0.9


def _small_sim(**kw):
    _, ctrl = _controllers("fov", 3)
    return MultiAgentSim(ctrl, 3, structured=True, solver_cfg=IPM_F32_ENTRY, **kw)


def _start(num_agents=3, dtype=F64):
    tasks = instances.circle_rotate_instance(num_agents, radius=2.5)["tasks"]
    so = torch.as_tensor(tasks["so"], dtype=dtype)
    return State(so, torch.zeros_like(so)), torch.as_tensor(tasks["sf"], dtype=dtype)


def test_plain_agent_batch_is_one_scenario():
    """[A, ...] inputs are the case S = 1: the same numbers as a [1, A, ...]
    batch, without the leading axis."""
    sim = _small_sim()
    init, goals = _start()
    one = sim.rollout(init, goals, 2)
    batched = sim.rollout(State(init.pos[None], init.vel[None]), goals[None], 2)
    assert one.traj_pos.shape == (2, 3, 3) and batched.traj_pos.shape == (1, 2, 3, 3)
    torch.testing.assert_close(one.traj_pos, batched.traj_pos[0], rtol=0, atol=0)
    torch.testing.assert_close(one.success, batched.success[0], rtol=0, atol=0)
    assert one.states.pos.dtype == F64 and torch.isfinite(one.traj_pos).all()


def test_noisy_rollout_is_deterministic_per_seed():
    sim = _small_sim(noise_pos_std=0.01, noise_vel_std=0.01)
    init, goals = _start()
    run = lambda seed: sim.rollout(init, goals, 2, torch.Generator().manual_seed(seed))
    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a.traj_pos, b.traj_pos, rtol=0, atol=0)
    assert not torch.equal(a.traj_pos, c.traj_pos)
    # the default generator is seeded with 0
    torch.testing.assert_close(sim.rollout(init, goals, 2).traj_pos, run(0).traj_pos,
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        sim.fly(torch.zeros(3, 36, dtype=F64), init, torch.ones(3, dtype=torch.bool))


def test_add_random_noise_uses_the_generator():
    st = State(torch.zeros(4, 3, dtype=F64), torch.zeros(4, 3, dtype=F64))
    a = add_random_noise(torch.Generator().manual_seed(1), st, 0.1, 0.0)
    b = add_random_noise(torch.Generator().manual_seed(1), st, 0.1, 0.0)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)
    assert a.pos.std() > 0.01 and not a.vel.any() and a.pos.dtype == F64


def test_dense_path_control_step_runs():
    """structured=False runs every agent's own QP through the dense ADMM
    (tests/test_torch_cbf_sims.py holds it against the JAX package)."""
    _, ctrl = _controllers("connectivity", 4)
    init, goals = _start(4)
    coeffs, success, flyable = MultiAgentSim(ctrl, 4).control_step(init, goals)
    assert coeffs.shape == (4, ctrl.op.n_dec) and success.shape == flyable.shape == (4,)
    assert bool(torch.isfinite(coeffs[flyable]).all()) and bool(flyable.any())


def test_default_solver_is_the_jax_default_admm_budget():
    _, ctrl = _controllers("connectivity", 4)
    simpc = MultiAgentSim(ctrl, 4, structured=True)._structured_impc()
    assert isinstance(simpc, StructuredIMPC) and simpc.cfg == StructuredConfig(iters=150)


def test_neighbor_mask_and_blobs_match_jax():
    """The fov sensing mask (square of side ~5.7 m, diagonals 8 m beyond
    Rs = 6) and the neighbor blobs equal the JAX package's."""
    ctrl_j, ctrl_t = _controllers("fov", 4)
    r = 4.0
    so = np.array([[r, 0, 0.3], [0, r, 0], [-r, 0, 0], [0, -r, 0]])
    vel = np.arange(12.0).reshape(4, 3) / 10
    st_j = JState(pos=jnp.asarray(so), vel=jnp.asarray(vel))
    st_t = State(torch.from_numpy(so), torch.from_numpy(vel))
    for rs in (None, 0.0):
        sim_j = JMultiAgentSim(ctrl_j, 4, sensing_radius=rs)
        sim_t = MultiAgentSim(ctrl_t, 4, sensing_radius=rs)
        blobs_j = sim_j._blobs(st_j)
        np.testing.assert_array_equal(sim_t._blobs(st_t).numpy(), np.asarray(blobs_j))
        np.testing.assert_array_equal(sim_t._neighbor_mask(st_t, sim_t._blobs(st_t)).numpy(),
                                      np.asarray(sim_j._neighbor_mask(st_j, blobs_j)))
    _, conn_t = _controllers("connectivity", 4)
    blob = MultiAgentSim(conn_t, 4)._blobs(st_t)
    np.testing.assert_array_equal(blob[0].numpy(), np.concatenate([so, vel], -1)[1:])


def test_yaw_helpers_match_jax():
    rng = np.random.default_rng(0)
    cur = rng.uniform(-7, 7, 64)
    goal = rng.uniform(-4, 4, 64)
    # ties: current yaw exactly halfway between two candidates
    cur[:4] = goal[:4] + np.pi
    cur[4:8] = goal[4:8] - np.pi
    np.testing.assert_array_equal(
        convert_to_closest_yaw(torch.from_numpy(cur), torch.from_numpy(goal)).numpy(),
        np.asarray(j_closest_yaw(jnp.asarray(cur), jnp.asarray(goal))))
    np.testing.assert_array_equal(convert_yaw_in_range(torch.from_numpy(cur)).numpy(),
                                  np.asarray(j_yaw_in_range(jnp.asarray(cur))))


@pytest.mark.parametrize("name,args", [
    ("circle_swap_instance", (5,)), ("circle_rotate_instance", (4, 2.5)),
    ("line_to_line_instance", (3,)), ("random_instance", (8, 5.0, 1.5, 7)),
    ("formation_instance", (5,)), ("fov_circle_instance", (6,))])
def test_instances_match_jax(name, args):
    assert getattr(instances, name)(*args) == getattr(j_instances, name)(*args)


def test_instance_success_matches_jax():
    rng = np.random.default_rng(2)
    goals = np.array([[0.0, 0.0], [3.0, 0.0], [0.0, 3.0]])
    walk = goals[:, None, :] + np.linspace(1, 0, 20)[None, :, None] * rng.normal(0, 2, (3, 1, 2))
    collide = walk.copy()
    collide[1, 5] = collide[0, 5]
    far = walk.copy()
    far[2, -1] += 5.0
    nan = walk.copy()
    nan[0, 3, 0] = np.nan
    for traj in (walk, collide, far, nan):
        for kw in ({}, dict(shape_type="circle", collision_shape=0.3)):
            assert metrics.instance_success(traj, goals, **kw) == \
                j_metrics.instance_success(traj, goals, **kw)
    assert metrics.instance_success(walk, goals)[0]
    assert not metrics.instance_success(collide, goals)[0]
