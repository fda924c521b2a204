"""The port's closed loops that run on the dense ADMM (CBFOnlySim,
BezierMPCSim and MultiAgentSim(structured=False)) against the JAX rollouts
over a few steps without noise, in float64 on the same instances.

Tolerance: 1e-6 on positions, velocities and controls after 4 steps (each
f64 solve agrees to ~1e-12; a step's QP is assembled from the last step's
state), per-step solver flags equal. With the particle filter the two
packages draw different numbers, so that loop is compared statistically:
both track the visible neighbor within the same bound.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.ops import cbf as jcbf
from mpc_cbf_tpu.ops.qp import ADMMConfig as JADMMConfig
from mpc_cbf_tpu import controllers as jc
from mpc_cbf_tpu import parallel as jp

from mpc_cbf_torch.types import State
from mpc_cbf_torch.ops import cbf
from mpc_cbf_torch.ops.qp import ADMMConfig
from mpc_cbf_torch import controllers as tc
from mpc_cbf_torch import parallel as tp

F64 = torch.float64
T = lambda a: torch.as_tensor(np.array(a), dtype=F64)
J = jnp.asarray
MPC, JMPC = tc.MPCParams(), jc.MPCParams()
STEPS, ITERS = 4, 80


def _ring(R, radius=2.0, seed=0, noise=0.05):
    """A cyclic rotation on a circle with a little start noise, yaw included."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(R) / R
    base = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(R)], axis=-1)
    return base + rng.normal(0, noise, base.shape), np.roll(base, -1, axis=0)


def _rollouts(sim, jsim, so, sf, steps=STEPS):
    R = so.shape[0]
    res = sim.rollout(State(T(so), T(np.zeros((R, 3)))), T(sf), steps)
    jres = jsim.rollout(JState(pos=J(so), vel=jnp.zeros((R, 3))), J(sf), steps)
    return res, jres


def _assert_traj_equal(res, jres, atol=1e-6):
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(jres.success))
    np.testing.assert_allclose(res.traj_pos.numpy(), np.asarray(jres.traj_pos), rtol=0, atol=atol)
    np.testing.assert_allclose(res.traj_vel.numpy(), np.asarray(jres.traj_vel), rtol=0, atol=atol)
    np.testing.assert_allclose(res.states.pos.numpy(), np.asarray(jres.states.pos), rtol=0,
                               atol=atol)


def _fov_cbf_sims(R, slack, **sim_kw):
    kw = dict(u_min=MPC.a_min, u_max=MPC.a_max, slack_mode=slack)
    ctrl = tc.FovCBFController(cbf.FovCBF(2.0943951023931953, 0.5, 6.0, MPC.v_min, MPC.v_max),
                               R - 1, solver=ADMMConfig(iters=ITERS), **kw)
    jctrl = jc.FovCBFController(
        jcbf.FovCBF(2.0943951023931953, 0.5, 6.0, J(JMPC.v_min), J(JMPC.v_max)), R - 1,
        solver=JADMMConfig(iters=ITERS), **kw)
    return tp.CBFOnlySim(ctrl, R, dt=0.1, **sim_kw), jp.CBFOnlySim(jctrl, R, dt=0.1, **sim_kw)


@pytest.mark.parametrize("slack", [False, True], ids=["hard", "slack"])
def test_cbf_only_sim_fov_matches_jax(slack):
    R = 3
    sim, jsim = _fov_cbf_sims(R, slack)
    so, sf = _ring(R)
    so[:, 2] = np.arctan2(-so[:, 1], -so[:, 0])           # facing the centre
    res, jres = _rollouts(sim, jsim, so, sf)
    assert res.traj_pos.shape == (STEPS, R, 3) and res.u.shape == (STEPS, R, 3)
    assert res.est_mean.shape == (STEPS, R, R - 1, 2)
    assert res.est_cov.shape == (STEPS, R, R - 1, 2, 2)
    _assert_traj_equal(res, jres)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.est_mean.numpy(), np.asarray(jres.est_mean), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res.est_cov.numpy(), np.asarray(jres.est_cov))


def test_cbf_only_sim_connectivity_matches_jax():
    R = 3
    ctrl = tc.ConnectivityCBFController(cbf.ConnectivityCBF(0.8, 10.0, MPC.v_min, MPC.v_max), R,
                                        solver=ADMMConfig(iters=ITERS))
    jctrl = jc.ConnectivityCBFController(
        jcbf.ConnectivityCBF(0.8, 10.0, J(JMPC.v_min), J(JMPC.v_max)), R,
        solver=JADMMConfig(iters=ITERS))
    so, sf = _ring(R, seed=1)
    res, jres = _rollouts(tp.CBFOnlySim(ctrl, R, dt=0.1), jp.CBFOnlySim(jctrl, R, dt=0.1), so, sf)
    _assert_traj_equal(res, jres)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-6)
    assert not res.est_mean.any() and res.est_mean.shape == (STEPS, R, R - 1, 2)
    with pytest.raises(ValueError):
        tp.CBFOnlySim(ctrl, R, use_pf=True).rollout(State(T(so), T(np.zeros((R, 3)))), T(sf), 1)


def test_cbf_only_sim_scenario_axis_and_failure_path():
    """[S, A, ...] in, [S, T, A, ...] out, each scenario equal to its own
    rollout; an agent whose solve failed brakes to zero velocity and holds."""
    R = 3
    sim, _ = _fov_cbf_sims(R, True)
    inst = [_ring(R, seed=s) for s in (0, 5)]
    so, sf = np.stack([i[0] for i in inst]), np.stack([i[1] for i in inst])
    res = sim.rollout(State(T(so), T(np.zeros_like(so))), T(sf), 3)
    assert res.traj_pos.shape == (2, 3, R, 3) and res.success.shape == (2, 3, R)
    one = sim.rollout(State(T(so[1]), T(np.zeros((R, 3)))), T(sf[1]), 3)
    torch.testing.assert_close(res.traj_pos[1], one.traj_pos, rtol=0, atol=1e-12)
    prev = State(T(so[0]), T(np.ones((R, 3))))
    nxt = sim.fly(prev, T(np.ones((R, 3))), torch.tensor([True, False, True]))
    assert bool((nxt.vel[1] == 0).all()) and bool((nxt.vel[0] != 0).all())
    torch.testing.assert_close(nxt.pos[1], prev.pos[1] + 0.1 * prev.vel[1], rtol=0, atol=1e-15)


def test_cbf_only_sim_with_particle_filter_tracks_like_jax():
    """tests/test_cbf_only_sims.py::test_cbf_fov_pf_estimator_tracks on both
    packages: different draws, the same bound on the tracking error."""
    R, steps = 2, 12
    kw = dict(u_min=MPC.a_min, u_max=MPC.a_max)
    ctrl = tc.FovCBFController(cbf.FovCBF(2 * np.pi, 0.5, 20.0, MPC.v_min, MPC.v_max), R - 1,
                               solver=ADMMConfig(iters=ITERS), **kw)
    jctrl = jc.FovCBFController(jcbf.FovCBF(2 * np.pi, 0.5, 20.0, J(JMPC.v_min), J(JMPC.v_max)),
                                R - 1, solver=JADMMConfig(iters=ITERS), **kw)
    so = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    sf = np.array([[3.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    res = tp.CBFOnlySim(ctrl, R, dt=0.1, use_pf=True).rollout(
        State(T(so), T(np.zeros((R, 3)))), T(sf), steps, torch.Generator().manual_seed(1))
    jres = jp.CBFOnlySim(jctrl, R, dt=0.1, use_pf=True).rollout(
        JState(pos=J(so), vel=jnp.zeros((R, 3))), J(sf), steps, key=jax.random.PRNGKey(1))
    for est, traj in ((res.est_mean.numpy(), res.traj_pos.numpy()),
                      (np.asarray(jres.est_mean), np.asarray(jres.traj_pos))):
        assert est.shape == (steps, R, 1, 2) and np.isfinite(est).all()
        err = np.linalg.norm(est[-5:, 0, 0] - traj[-5:, 1, :2], axis=-1)
        assert err.max() < 0.5, err
    assert np.isfinite(res.est_cov.numpy()).all()
    # the closed loops stay close: the estimates differ by the filters' spread only
    assert np.abs(res.traj_pos.numpy() - np.asarray(jres.traj_pos)).max() < 0.2


@pytest.mark.parametrize("R", [1, 3])
def test_bezier_mpc_sim_matches_jax(R):
    op = tc.BezierMPCOperator(tc.BezierParams(), MPC, dim=3, device="cpu", dtype=F64)
    jop = jc.BezierMPCOperator(jc.BezierParams(), JMPC, dim=3)
    ctrl = tc.BezierMPC(op, R - 1, box_half_extents=[0.3, 0.3, 0.0], solver=ADMMConfig(iters=ITERS))
    jctrl = jc.BezierMPC(jop, R - 1, box_half_extents=[0.3, 0.3, 0.0],
                         solver=JADMMConfig(iters=ITERS))
    so, sf = _ring(R, seed=2)
    if R == 1:
        sf = so + np.array([[1.5, -0.5, 0.3]])
    res, jres = _rollouts(tp.BezierMPCSim(ctrl, R), jp.BezierMPCSim(jctrl, R), so, sf)
    _assert_traj_equal(res, jres)
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs), rtol=0, atol=1e-6)
    assert res.certified is None


@pytest.mark.parametrize("kind", ["fov_slack", "connectivity", "connectivity_lambda2"])
def test_dense_multi_agent_sim_matches_jax(kind):
    """MultiAgentSim(structured=False): every agent's own QP through the
    dense ADMM, as the JAX package vmaps `optimize`."""
    R = 3
    op = tc.BezierMPCOperator(tc.BezierParams(), MPC, dim=3, device="cpu", dtype=F64)
    jop = jc.BezierMPCOperator(jc.BezierParams(), JMPC, dim=3)
    solver, jsolver = ADMMConfig(iters=ITERS), JADMMConfig(iters=ITERS)
    if kind == "fov_slack":
        ctrl = tc.FovIMPCCBF(op, cbf.FovCBF(2.0943951023931953, 0.3, 6.0, MPC.v_min, MPC.v_max),
                             tc.IMPCParams(slack_mode=True), R - 1,
                             box_half_extents=[0.1, 0.1, 0.0], solver=solver)
        jctrl = jc.FovIMPCCBF(
            jop, jcbf.FovCBF(2.0943951023931953, 0.3, 6.0, J(JMPC.v_min), J(JMPC.v_max)),
            jc.IMPCParams(slack_mode=True), R - 1, box_half_extents=[0.1, 0.1, 0.0],
            solver=jsolver)
    else:
        enable = kind == "connectivity_lambda2"
        ctrl = tc.ConnectivityIMPCCBF(op, cbf.ConnectivityCBF(0.5, 4.0, MPC.v_min, MPC.v_max),
                                      tc.IMPCParams(), R - 1, solver=solver,
                                      enable_connectivity=enable)
        jctrl = jc.ConnectivityIMPCCBF(
            jop, jcbf.ConnectivityCBF(0.5, 4.0, J(JMPC.v_min), J(JMPC.v_max)), jc.IMPCParams(),
            R - 1, solver=jsolver, enable_connectivity=enable)
    so, sf = _ring(R, seed=3)
    so[:, 2] = np.arctan2(-so[:, 1], -so[:, 0])
    res, jres = _rollouts(tp.MultiAgentSim(ctrl, R), jp.MultiAgentSim(jctrl, R), so, sf, steps=3)
    _assert_traj_equal(res, jres)
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs), rtol=0, atol=1e-6)
    assert not res.certified.any() and res.certified.shape == (3, R)
    # the dense path carries no duals
    out = tp.MultiAgentSim(ctrl, R).control_step(State(T(so), T(np.zeros((R, 3)))), T(sf),
                                                 return_duals=True)
    assert out[3] is None and out[0].shape == (R, op.n_dec)


def test_eight_robot_ring_defeats_the_cbf_fov_qp_in_both_packages():
    """On the 8-robot ring of a sweep (radius 4, a 120-degree field of view
    that cannot hold seven neighbours, slack mode on as run_sim builds it)
    the cbf-fov QPs carry capped bounds of -1e6 against slacks of 1e6, and
    200 float32 ADMM iterations converge on few of them: the solver's
    success rate over the first 15 steps is under 0.3 in the JAX package and
    in the port alike (float32; the packages' flags differ by rounding, so
    the rates are held within 0.1 of each other, not lane by lane)."""
    from mpc_cbf_torch.apps import run_sim
    from mpc_cbf_torch.utils import config as cfgmod
    from mpc_cbf_torch.utils.instances import circle_rotate_instance

    cfg = cfgmod.load_config("configs/base_config.json")
    tasks = circle_rotate_instance(8, radius=4.0)["tasks"]
    so, sf = np.asarray(tasks["so"]), np.asarray(tasks["sf"])
    so = so + np.concatenate([np.random.default_rng(0).normal(0, 0.05, (8, 2)),
                              np.zeros((8, 1))], -1)
    steps = 15
    sim, mpc = run_sim.build_sim(cfg, "cbf-fov", 8, 200, device="cpu")
    # the JAX controller as its run_sim builds it, with float32 constants (this
    # test process runs JAX with x64 on, where tuples would become float64)
    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))
    fov = cfg["fov_cbf_params"]
    impc = cfgmod.parse_impc_params(cfg)
    jctrl = jc.FovCBFController(
        jcbf.FovCBF(np.float32(fov["beta"] * np.pi / 180.0), fov["Ds"], fov["Rs"],
                    f32(mpc.v_min), f32(mpc.v_max)), 7, u_min=f32(mpc.a_min), u_max=f32(mpc.a_max),
        solver=JADMMConfig(iters=200), slack_mode=impc.slack_mode, slack_cost=impc.slack_cost,
        slack_decay_rate=impc.slack_decay_rate)
    jsim = jp.CBFOnlySim(jctrl, 8, dt=mpc.h)
    F32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)
    res = sim.rollout(State(F32(so), F32(np.zeros((8, 3)))), F32(sf), steps)
    jres = jsim.rollout(JState(pos=J(so).astype(jnp.float32), vel=jnp.zeros((8, 3), jnp.float32)),
                        J(sf).astype(jnp.float32), steps)
    rate, jrate = float(res.success.float().mean()), float(np.asarray(jres.success).mean())
    assert rate < 0.3 and jrate < 0.3, (rate, jrate)
    assert abs(rate - jrate) < 0.1, (rate, jrate)
    assert torch.isfinite(res.traj_pos).all()
    # No control is compared: where 200 iterations stop short of the optimum,
    # two float32 runs of one package sit as far apart as the two packages do
    # (0.4 in u on the first step). The float64 loops above agree to 1e-6.
