"""The dense route of the port's controllers against the JAX package, in
float64 on the same numpy inputs: `assemble` of every controller class row
for row, and the results of `optimize`, `plan`, `control` and `control_all`.

The port's methods take a batch of lanes; the JAX ones take one lane and are
vmapped here as their callers vmap them. Tolerances: 1e-9 on assembled
matrices (autodiff rows and an eigensolver differ in the last bits), 1e-6
on solutions after a fixed number of ADMM iterations (the f64 solvers agree
to ~1e-12 per solve; IMPC iteration 1 is assembled from iteration 0's
solution; slack values, which reach 1e5 on violated rows, 1e-6 relative),
flags equal.
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

from mpc_cbf_torch.types import State
from mpc_cbf_torch.ops import cbf
from mpc_cbf_torch.ops.qp import ADMMConfig
from mpc_cbf_torch import controllers as tc
from mpc_cbf_torch.controllers.cbf_qp import _rank_weights, _slack_padded

import torch_parity_cases as cases

F64 = torch.float64
T = lambda a: torch.as_tensor(np.array(a), dtype=F64)
J = jnp.asarray
ITERS = 60
BOX = cases.BOX
FIELDS = ("P", "q", "A", "lb", "ub")


def _impc_pair(kind):
    """(port controller, JAX controller, inputs maker) of one IMPC class."""
    mpc, jmpc = tc.MPCParams(), jc.MPCParams()
    op = tc.BezierMPCOperator(tc.BezierParams(), mpc, dim=3, device="cpu", dtype=F64)
    jop = jc.BezierMPCOperator(jc.BezierParams(), jmpc, dim=3)
    solver, jsolver = ADMMConfig(iters=ITERS), JADMMConfig(iters=ITERS)
    jv = lambda v: jnp.asarray(v)
    if kind in ("fov", "fov_slack"):
        impc = dict(slack_mode=kind == "fov_slack")
        ctrl = tc.FovIMPCCBF(op, cbf.FovCBF(cases.FOV_BETA, 0.3, 6.0, mpc.v_min, mpc.v_max),
                             tc.IMPCParams(**impc), 3, box_half_extents=BOX, solver=solver)
        jctrl = jc.FovIMPCCBF(jop, jcbf.FovCBF(cases.FOV_BETA, 0.3, 6.0, jv(jmpc.v_min),
                                               jv(jmpc.v_max)),
                              jc.IMPCParams(**impc), 3, box_half_extents=BOX, solver=jsolver)
        return ctrl, jctrl, lambda rng, B: cases.fov_inputs(rng, B, 3)
    if kind == "single_shot":
        ctrl = tc.BezierMPCCBF(op, cbf.FovCBF(cases.FOV_BETA, 0.3, 6.0, mpc.v_min, mpc.v_max), 3,
                               solver=solver)
        jctrl = jc.BezierMPCCBF(jop, jcbf.FovCBF(cases.FOV_BETA, 0.3, 6.0, jv(jmpc.v_min),
                                                 jv(jmpc.v_max)), 3, solver=jsolver)

        def inputs(rng, B):
            pos, vel, ref, blob, mask = cases.fov_inputs(rng, B, 3)
            return pos, vel, ref, blob[..., :2], mask
        return ctrl, jctrl, inputs
    enable = kind == "connectivity_lambda2"
    ctrl = tc.ConnectivityIMPCCBF(op, cbf.ConnectivityCBF(1.0, 4.0, mpc.v_min, mpc.v_max),
                                  tc.IMPCParams(), 3, solver=solver, enable_connectivity=enable)
    jctrl = jc.ConnectivityIMPCCBF(jop, jcbf.ConnectivityCBF(1.0, 4.0, jv(jmpc.v_min),
                                                             jv(jmpc.v_max)),
                                   jc.IMPCParams(), 3, solver=jsolver, enable_connectivity=enable)
    return ctrl, jctrl, lambda rng, B: cases.conn_inputs(rng, B, 3)


IMPC_KINDS = ["fov", "fov_slack", "single_shot", "connectivity", "connectivity_lambda2"]


def _assert_qp_equal(qp, jqp, atol=1e-9):
    B = qp.q.shape[0]
    for name in FIELDS:
        got, want = getattr(qp, name), np.asarray(getattr(jqp, name))
        got = got.expand(B, *got.shape[-2:]) if name in ("P", "A") else got
        assert tuple(got.shape) == want.shape, name
        # bounds reach 1e6 (the CBF cap) and +-1e20 (inactive rows)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=atol, err_msg=name)


@pytest.mark.parametrize("later_iteration", [False, True], ids=["iter0", "iter1"])
@pytest.mark.parametrize("kind", IMPC_KINDS)
def test_impc_assemble_matches_jax(kind, later_iteration):
    ctrl, jctrl, make = _impc_pair(kind)
    rng = np.random.default_rng(11)
    B, H = 4, ctrl.impc.cbf_horizon
    pos, vel, ref, blob, mask = make(rng, B)
    mask[1, 0] = False                                   # one masked neighbor
    x = np.concatenate([pos, vel], -1)
    if later_iteration:
        pred = x[:, None, :] + rng.normal(0, 0.05, (B, H, 6))
        active = np.ones(H, bool)
    else:
        pred = np.broadcast_to(x[:, None, :], (B, H, 6))
        active = np.arange(H) == 0
    qp = ctrl.assemble(State(T(pos), T(vel)), T(ref), T(blob), torch.as_tensor(mask), T(pred),
                       torch.as_tensor(active))
    jqp = jax.vmap(lambda p, v, r, b, m, pr: jctrl.assemble(
        JState(pos=p, vel=v), r, b, m, pr, J(active)))(J(pos), J(vel), J(ref), J(blob), J(mask),
                                                        J(pred))
    assert qp.P.shape == (ctrl.n, ctrl.n)                # shared by the lanes
    assert qp.A.shape[1] == jqp.A.shape[1] == qp.lb.shape[1]
    _assert_qp_equal(qp, jqp)


@pytest.mark.parametrize("kind", IMPC_KINDS)
def test_impc_optimize_matches_jax(kind):
    ctrl, jctrl, make = _impc_pair(kind)
    rng = np.random.default_rng(12)
    B = 3
    pos, vel, ref, blob, mask = make(rng, B)
    res = ctrl.optimize(State(T(pos), T(vel)), T(ref), T(blob), torch.as_tensor(mask))
    jres = jax.vmap(lambda p, v, r, b, m: jctrl.optimize(JState(pos=p, vel=v), r, b, m))(
        J(pos), J(vel), J(ref), J(blob), J(mask))
    assert res.coeffs.shape == (B, ctrl.op.n_dec)
    assert res.iterates.shape == (ctrl.impc.impc_iter, B, ctrl.op.n_dec)
    for name in ("success", "flyable", "all_converged"):
        np.testing.assert_array_equal(getattr(res, name).numpy(), np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_allclose(res.coeffs.numpy(), np.asarray(jres.coeffs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.iterates.numpy(),
                               np.asarray(jres.iterates).transpose(1, 0, 2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.pri_res.numpy(), np.asarray(jres.pri_res), rtol=0, atol=1e-6)
    assert res.ys is None and res.certified is None
    # a warm start is taken
    warm = torch.cat([res.coeffs, res.coeffs.new_zeros((B, ctrl.n - ctrl.op.n_dec))], -1)
    res_w = ctrl.optimize(State(T(pos), T(vel)), T(ref), T(blob), torch.as_tensor(mask),
                          warm=warm)
    jres_w = jax.vmap(lambda p, v, r, b, m, w: jctrl.optimize(JState(pos=p, vel=v), r, b, m, w))(
        J(pos), J(vel), J(ref), J(blob), J(mask), J(warm.numpy()))
    np.testing.assert_allclose(res_w.coeffs.numpy(), np.asarray(jres_w.coeffs), rtol=0, atol=1e-6)


def test_single_shot_derivative_control_inputs():
    ctrl, jctrl, _ = _impc_pair("single_shot")
    z = np.random.default_rng(2).normal(size=(3, ctrl.op.n_dec))
    got = ctrl.derivative_control_inputs(T(z), 2)
    want = jax.vmap(lambda c: jctrl.derivative_control_inputs(c, 2))(J(z))
    assert got.shape == (3, len(ctrl.op.ts_samples) * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("N", [0, 2])
def test_bezier_mpc_assemble_and_plan_match_jax(N):
    mpc, jmpc = tc.MPCParams(), jc.MPCParams()
    op = tc.BezierMPCOperator(tc.BezierParams(), mpc, dim=3, device="cpu", dtype=F64)
    jop = jc.BezierMPCOperator(jc.BezierParams(), jmpc, dim=3)
    ctrl = tc.BezierMPC(op, N, box_half_extents=[0.3, 0.3, 0.0], solver=ADMMConfig(iters=ITERS))
    jctrl = jc.BezierMPC(jop, N, box_half_extents=[0.3, 0.3, 0.0],
                         solver=JADMMConfig(iters=ITERS))
    assert ctrl.m == jctrl.m
    rng = np.random.default_rng(13)
    B = 3
    pos, vel, ref, blob, mask = cases.conn_inputs(rng, B, max(N, 1))
    others, mask = blob[:, :N, :3], mask[:, :N]
    if N:
        mask[2, 1] = False
    cur, jcur = State(T(pos), T(vel)), (J(pos), J(vel))
    qp = ctrl.assemble(cur, T(ref), T(others), torch.as_tensor(mask))
    jqp = jax.vmap(lambda p, v, r, o, m: jctrl.assemble(JState(pos=p, vel=v), r, o, m))(
        *jcur, J(ref), J(others), J(mask))
    assert qp.A.shape[1] == ctrl.m
    _assert_qp_equal(qp, jqp)
    coeffs, sol = ctrl.plan(cur, T(ref), T(others), torch.as_tensor(mask))
    jcoeffs, jsol = jax.vmap(lambda p, v, r, o, m: jctrl.plan(JState(pos=p, vel=v), r, o, m))(
        *jcur, J(ref), J(others), J(mask))
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jcoeffs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(jsol.converged))
    # warm start (x0, y0)
    coeffs_w, _ = ctrl.plan(cur, T(ref), T(others), torch.as_tensor(mask), warm=(sol.z, sol.y))
    jcoeffs_w, _ = jax.vmap(lambda p, v, r, o, m, x0, y0: jctrl.plan(
        JState(pos=p, vel=v), r, o, m, warm=(x0, y0)))(
        *jcur, J(ref), J(others), J(mask), jsol.z, jsol.y)
    np.testing.assert_allclose(coeffs_w.numpy(), np.asarray(jcoeffs_w), rtol=0, atol=1e-6)


def test_operator_rows_match_jax():
    """equality_rows, cbf_row_from_state_row and eval_solution."""
    mpc, jmpc = tc.MPCParams(), jc.MPCParams()
    op = tc.BezierMPCOperator(tc.BezierParams(), mpc, dim=3, device="cpu", dtype=F64)
    jop = jc.BezierMPCOperator(jc.BezierParams(), jmpc, dim=3)
    rng = np.random.default_rng(3)
    pos, vel = rng.normal(size=(2, 4, 3))
    A, lb, ub = op.equality_rows(State(T(pos), T(vel)))
    for b in range(4):
        jA, jlb, jub = jop.equality_rows(JState(pos=J(pos[b]), vel=J(vel[b])))
        np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
        np.testing.assert_array_equal(lb[b].numpy(), np.asarray(jlb))
        np.testing.assert_array_equal(ub[b].numpy(), np.asarray(jub))
    a, bb = rng.normal(size=(4, 3)), rng.normal(size=4)
    k = np.array([0, 1, 5, 15])
    rows, ubs = op.cbf_row_from_state_row(T(a), T(bb), torch.as_tensor(k))
    for i in range(4):
        jrow, jb = jop.cbf_row_from_state_row(J(a[i]), J(bb[i]), int(k[i]), jnp.float64)
        np.testing.assert_allclose(rows[i].numpy(), np.asarray(jrow), rtol=0, atol=1e-12)
        assert float(ubs[i]) == float(jb)
    row1, _ = op.cbf_row_from_state_row(T(a[2]), T(bb[2]), 5)
    torch.testing.assert_close(row1, rows[2], rtol=0, atol=0)
    z = rng.normal(size=(2, 5, op.n_dec))
    for d in (0, 1):
        got = op.eval_solution(T(z), [0.0, 0.1, 0.75], d)
        assert got.shape == (2, 5, 3, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(jop.eval_solution(
            J(z), [0.0, 0.1, 0.75], d)), rtol=0, atol=1e-10)


# -- single-step CBF-QP controllers -----------------------------------------

VMIN = [-2.0, -2.0, -2.6179938779914944]
VMAX = [2.0, 2.0, 2.6179938779914944]
FOV120 = 2.0943951023931953


def _fov_pair(slack, bounds=True, N=2):
    kw = dict(slack_mode=slack)
    if bounds:
        kw.update(u_min=[-5, -5, -3.14], u_max=[5, 5, 3.14])
    return (tc.FovCBFController(cbf.FovCBF(FOV120, 1.0, 6.0, VMIN, VMAX), N,
                                solver=ADMMConfig(iters=ITERS), **kw),
            jc.FovCBFController(jcbf.FovCBF(FOV120, 1.0, 6.0, VMIN, VMAX), N,
                                solver=JADMMConfig(iters=ITERS), **kw))


def _fov_lanes(rng, B, N):
    state = rng.normal(0, 0.5, (B, 6))
    state[0] = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]         # tests/test_cbf_controllers.py:36-40
    u_des = rng.normal(0, 1.0, (B, 3))
    ang, rad = rng.uniform(-0.8, 0.8, (B, N)), rng.uniform(1.3, 4.5, (B, N))
    nbr = state[:, None, :2] + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    cov = np.broadcast_to(0.01 * np.eye(2), (B, N, 2, 2)).copy()
    cov[:, 1] *= 3.0
    mask = np.ones((B, N), bool)
    mask[1, 0] = False
    return state, u_des, nbr, cov, mask


@pytest.mark.parametrize("slack, bounds", [(False, True), (True, True), (False, False)],
                         ids=["hard", "slack", "no_control_bounds"])
def test_fov_cbf_controller_matches_jax(slack, bounds):
    ctrl, jctrl = _fov_pair(slack, bounds)
    args = _fov_lanes(np.random.default_rng(14), 5, 2)
    targs = tuple(torch.as_tensor(a) if a.dtype == bool else T(a) for a in args)
    qp = ctrl.assemble(*targs)
    jqp = jax.vmap(jctrl.assemble)(*(J(a) for a in args))
    assert ctrl.n == jctrl.n == qp.q.shape[-1]
    _assert_qp_equal(qp, jqp)
    res = ctrl.control(*targs)
    jres = jax.vmap(jctrl.control)(*(J(a) for a in args))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-6)
    # slacks of violated rows reach 1e5: relative
    np.testing.assert_allclose(res.slack.numpy(), np.asarray(jres.slack), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    np.testing.assert_allclose(res.pri_res.numpy(), np.asarray(jres.pri_res), rtol=0, atol=1e-6)


def _conn_pair(slack, R=3):
    return (tc.ConnectivityCBFController(cbf.ConnectivityCBF(0.8, 3.0, VMIN, VMAX), R,
                                         slack_mode=slack, solver=ADMMConfig(iters=ITERS)),
            jc.ConnectivityCBFController(jcbf.ConnectivityCBF(0.8, 3.0, J(VMIN), J(VMAX)), R,
                                         slack_mode=slack, solver=JADMMConfig(iters=ITERS)))


TEAMS = np.array([
    # generic positions near one another: the λ₂ branch
    [[0.0, 0.0, 0, 0.3, 0, 0], [1.2, 0.1, 0, -0.2, 0.1, 0], [0.2, 1.3, 0, 0, -0.1, 0]],
    # spread far apart: λ₂ ~ 0, the CLF branch (tests/test_cbf_controllers.py:117-119)
    [[0.0, 0.0, 0, 0, 0, 0], [10.0, 0.3, 0, 0, 0, 0], [0.4, 10.0, 0, 0, 0, 0]],
])


@pytest.mark.parametrize("slack", [False, True], ids=["hard", "slack"])
def test_connectivity_cbf_controller_matches_jax(slack):
    """assemble and control for every robot of a connected and a
    disconnected team (one lane each), and control_all with the hoisted
    team λ₂ on the batch of both teams."""
    ctrl, jctrl = _conn_pair(slack)
    rng = np.random.default_rng(15)
    R = 3
    u_des = rng.normal(0, 0.7, (2, R, 3))
    lam2, _ = ctrl.cbf.lambda2(T(TEAMS)[..., :2])
    assert float(lam2[0]) > ctrl.LAMBDA2_THRESHOLD > float(lam2[1])

    teams = np.repeat(TEAMS, R, axis=0)                       # lane = (team, robot)
    self_idx = np.tile(np.arange(R), 2)
    qp = ctrl.assemble(T(teams), torch.as_tensor(self_idx), T(u_des.reshape(-1, 3)))
    jqp = jax.vmap(jctrl.assemble)(J(teams), J(self_idx), J(u_des.reshape(-1, 3)))
    assert torch.isfinite(qp.A).all() and torch.isfinite(qp.ub).all()
    _assert_qp_equal(qp, jqp)

    res = ctrl.control(T(teams), torch.as_tensor(self_idx), T(u_des.reshape(-1, 3)))
    jres = jax.vmap(jctrl.control)(J(teams), J(self_idx), J(u_des.reshape(-1, 3)))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))

    res_all = ctrl.control_all(T(TEAMS), T(u_des))
    jres_all = jax.vmap(jctrl.control_all)(J(TEAMS), J(u_des))
    assert res_all.u.shape == (2, R, 3) and res_all.converged.shape == (2, R)
    np.testing.assert_allclose(res_all.u.numpy(), np.asarray(jres_all.u), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_all.slack.numpy(), np.asarray(jres_all.slack), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(res_all.converged.numpy(), np.asarray(jres_all.converged))
    # the hoisted λ₂ changes nothing: control_all is control on each lane
    torch.testing.assert_close(res_all.u.reshape(-1, 3), res.u, rtol=0, atol=1e-12)
    # one team without a batch axis
    res_one = ctrl.control_all(T(TEAMS[0]), T(u_des[0]))
    torch.testing.assert_close(res_one.u, res_all.u[0], rtol=0, atol=1e-12)


def test_rank_weights_mask_and_ties_and_slack_padding():
    d = np.array([[0.7, 0.2, 0.2, 1.5], [3.0, 1.0, 2.0, 0.5]])
    mask = np.array([[True, True, True, False], [True, False, True, True]])
    from mpc_cbf_tpu.controllers.cbf_qp import _rank_weights as jrank, _slack_padded as jpad
    got = _rank_weights(T(d), torch.as_tensor(mask), 100.0, 0.1)
    want = jax.vmap(lambda dd, mm: jrank(dd, mm, 100.0, 0.1))(J(d), J(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(got[0].numpy(), [1.0, 100.0, 10.0, 0.1], rtol=1e-12)  # tie by index
    # an index outside [0, S) gives a zero row (the ego when it is robot 0)
    rows = np.arange(9.0).reshape(3, 3)
    idx = np.array([-1, 0, 1])
    got = _slack_padded(T(rows), 2, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpad(J(rows), 2, J(idx))))
    np.testing.assert_array_equal(got[:, 3:].numpy(), [[0, 0], [-1, 0], [0, -1]])
