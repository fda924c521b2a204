"""The λ₂-connectivity, CLF and velocity rows of the port
(mpc_cbf_torch/ops/cbf.py, ConnectivityIMPCCBF(enable_connectivity=True))
against the reference's golden values (tests/test_cbf_golden.py), the row
lifts of tests/test_mpc_connectivity.py and the JAX package on the same
numpy inputs, in float64.

Eigenvectors are compared never raw: they are defined up to a sign (and up
to a rotation where λ₂ is repeated), so the tests use generic positions and
compare λ₂ and the assembled rows; one test shows that a flipped sign gives
the same rows. Tolerances: 1e-9 on rows between the packages (two
eigensolvers and two autodiff systems on the same float64 arithmetic).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.func import vmap

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.ops import cbf as jcbf
from mpc_cbf_tpu.ops import geometry as jgeom
from mpc_cbf_tpu.ops import controls as jcontrols
from mpc_cbf_tpu.controllers import (
    BezierParams as JBezierParams, MPCParams as JMPCParams,
    BezierMPCOperator as JOperator, IMPCParams as JIMPCParams,
    ConnectivityIMPCCBF as JConnectivityIMPCCBF)

from mpc_cbf_torch.types import BIG, State
from mpc_cbf_torch.ops import cbf, geometry, controls
from mpc_cbf_torch.controllers import (
    BezierParams, MPCParams, BezierMPCOperator, IMPCParams, ConnectivityIMPCCBF)

VMIN = -np.ones(3)
VMAX = np.ones(3)
F64 = torch.float64
T = lambda a: torch.as_tensor(np.array(a), dtype=F64)

LINE = [[1.0, 2.0, 0, 0, 0, 0], [1.0, 4.0, 0, 0, 0, 0], [1.0, 6.0, 0, 0, 0, 0]]
MISC2 = [[0.212, 1.592, 0, -0.293, -0.21, 0.0], [1.01, 4.20, 0, -1.2, 0.12, 0],
         [-1.0, -0.02, 0, -0.2, 0.16, 0]]


@pytest.mark.parametrize("states, a_want, b_want", [
    (LINE, [0.0, -2.703392, 0.0], 3.4635324630258153),
    (MISC2, [0.061292, 0.201971, 0.0], -2.2784138163109593),
], ids=["misc_line", "misc2"])
def test_lambda2_conn_row_goldens(states, a_want, b_want):
    """TestInitConnectivity.cpp fixture (min_dist=0.8, max_dist=3.0), the
    numbers of tests/test_cbf_golden.py::TestConnectivityLambda2."""
    c = cbf.ConnectivityCBF(0.8, 3.0, VMIN, VMAX)
    x = T(states)
    lam2, vec = c.lambda2(x[:, :2])
    a, b = c.conn_row(x[0], x, vec, lam2 - c.epsilon, 0)
    np.testing.assert_allclose(a.numpy(), a_want, atol=1e-6)
    np.testing.assert_allclose(float(b), b_want, rtol=1e-9)
    # and against the JAX package, every robot of the team
    jc = jcbf.ConnectivityCBF(0.8, 3.0, VMIN, VMAX)
    jx = jnp.asarray(states)
    jlam2, jvec = jc.lambda2(jx[:, :2])
    np.testing.assert_allclose(float(lam2), float(jlam2), rtol=1e-12)
    for i in range(3):
        a, b = c.conn_row(x[i], x, vec, lam2 - c.epsilon, torch.tensor(i))
        ja, jb = jc.conn_row(jx[i], jx, jvec, jlam2 - jc.epsilon, i)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-9)
        np.testing.assert_allclose(float(b), float(jb), rtol=1e-9)


def test_eigenvector_sign_drops_out_of_the_rows():
    c = cbf.ConnectivityCBF(0.8, 3.0, VMIN, VMAX)
    x = T(MISC2)
    lam2, vec = c.lambda2(x[:, :2])
    a, b = c.conn_row(x[1], x, vec, lam2 - c.epsilon, 1)
    a_neg, b_neg = c.conn_row(x[1], x, -vec, lam2 - c.epsilon, 1)
    torch.testing.assert_close(a, a_neg, rtol=0, atol=0)
    torch.testing.assert_close(b, b_neg, rtol=0, atol=0)


@pytest.mark.parametrize("other, a_want, b_want", [
    ([2.0, 0, 0, 0, 0, 0], None, 0.0),                 # at the desired distance
    ([3.0, 0, 0, 0, 0, 0], [-2.0, 0.0, 0.0], 2.0),     # too far: V = 1, b = beta2 V
], ids=["at_desired_distance", "gradient_direction"])
def test_clf_goldens(other, a_want, b_want):
    """tests/test_cbf_golden.py::TestCLF."""
    c = cbf.ConnectivityCBF(0.8, 2.0, VMIN, VMAX)
    a, b = c.clf_row(torch.zeros(6, dtype=F64), T(other))
    np.testing.assert_allclose(float(b), b_want, atol=1e-9)
    if a_want is not None:
        np.testing.assert_allclose(a.numpy(), a_want, atol=1e-9)


def test_clf_and_safety_rows_match_jax_on_random_states():
    rng = np.random.default_rng(0)
    c = cbf.ConnectivityCBF(0.8, 2.0, VMIN, VMAX)
    jc = jcbf.ConnectivityCBF(0.8, 2.0, VMIN, VMAX)
    x, nbr = rng.normal(0, 1.5, (6, 6)), rng.normal(0, 1.5, (6, 6))
    a, b = vmap(c.clf_row)(T(x), T(nbr))
    for i in range(6):
        ja, jb = jc.clf_row(jnp.asarray(x[i]), jnp.asarray(nbr[i]))
        np.testing.assert_allclose(a[i].numpy(), np.asarray(ja), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(b[i]), float(jb), rtol=1e-9, atol=1e-9)
    # the ego against itself: NaN, for callers to mask on the value
    a_self, _ = c.clf_row(T(x[0]), T(x[0]))
    assert torch.isnan(a_self[:2]).all()


@pytest.mark.parametrize("cls", ["FovCBF", "ConnectivityCBF"])
def test_vel_rows_golden(cls):
    """tests/test_cbf_golden.py::TestFov::test_vel_rows."""
    make = {"FovCBF": lambda m: m.FovCBF(2.0943951023931953, 2.0, 4.0, VMIN, VMAX),
            "ConnectivityCBF": lambda m: m.ConnectivityCBF(0.8, 2.0, VMIN, VMAX)}[cls]
    x = np.array([0.0, 0, 0, 0.5, -0.3, 0.2])
    A, b = make(cbf).vel_rows(T(x))
    assert A.shape == (6, 3) and b.shape == (6,)
    np.testing.assert_allclose(b.numpy(), [0.5, 1.3, 0.8, 1.5, 0.7, 1.2], atol=1e-12)
    jA, jb = make(jcbf).vel_rows(jnp.asarray(x))
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-15)
    # a batch of states through vmap
    Ab, bb = vmap(make(cbf).vel_rows)(T(np.stack([x, 2 * x])))
    assert Ab.shape == (2, 6, 3)
    torch.testing.assert_close(bb[0], b, rtol=0, atol=0)


def test_lambda2_mask_deflation_matches_subteam_and_jax():
    """tests/test_mpc_connectivity.py::test_lambda2_mask_deflation_matches_subteam,
    batched: the second team of the batch is the first one shifted."""
    c = cbf.ConnectivityCBF(0.5, 4.0, VMIN, VMAX)
    jc = jcbf.ConnectivityCBF(0.5, 4.0, VMIN, VMAX)
    pos5 = np.array([[0.0, 0.0], [2.0, 0.5], [0.5, 2.0], [9.0, 9.0], [-7.0, 3.0]])
    mask = np.array([True, True, True, False, False])
    lam_m, vec_m = c.lambda2(T(np.stack([pos5, pos5 + 1.0])),
                             torch.as_tensor(np.stack([mask, mask])))
    lam_s, vec_s = c.lambda2(T(pos5[:3]))
    assert lam_m.shape == (2,) and vec_m.shape == (2, 5)
    np.testing.assert_allclose(lam_m.numpy(), [float(lam_s)] * 2, rtol=1e-10)
    a = (vec_m[0, :3] / torch.linalg.vector_norm(vec_m[0, :3])).numpy()
    assert min(np.abs(a - vec_s.numpy()).max(), np.abs(a + vec_s.numpy()).max()) < 1e-8
    assert vec_m[:, 3:].abs().max() < 1e-6           # ghost entries carry ~no weight
    jlam, _ = jc.lambda2(jnp.asarray(pos5), jnp.asarray(mask))
    np.testing.assert_allclose(float(lam_m[0]), float(jlam), rtol=1e-10)
    np.testing.assert_allclose(c.adjacency(T(pos5)).numpy(),
                               np.asarray(jc.adjacency(jnp.asarray(pos5))), rtol=1e-12)
    assert abs(c.sigma - jc.sigma) < 1e-12


def test_eigh_runs_in_slices_beyond_the_library_limit(monkeypatch):
    """More matrices than one call may take (cuSOLVER's batched syev refuses
    32 767 and more on the card) go through in slices, with the same result."""
    c = cbf.ConnectivityCBF(0.5, 4.0, VMIN, VMAX)
    pos = T(np.random.default_rng(4).normal(0, 1.5, (3, 7, 4, 2)))
    lam_whole, vec_whole = c.lambda2(pos)
    monkeypatch.setattr(cbf, "EIGH_MAX_BATCH", 4)          # 21 teams: 5 full slices and 1
    lam, vec = c.lambda2(pos)
    assert lam.shape == (3, 7) and vec.shape == (3, 7, 4)
    torch.testing.assert_close(lam, lam_whole, rtol=0, atol=1e-13)
    torch.testing.assert_close(vec.abs(), vec_whole.abs(), rtol=0, atol=1e-10)


# -- the row lifts of ConnectivityIMPCCBF(enable_connectivity=True) ----------


def _ctrls(N=3, dmin=0.5, dmax=4.0):
    mpc, jmpc = MPCParams(), JMPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device="cpu", dtype=F64)
    ctrl = ConnectivityIMPCCBF(op, cbf.ConnectivityCBF(dmin, dmax, mpc.v_min, mpc.v_max),
                               IMPCParams(), N, enable_connectivity=True)
    jop = JOperator(JBezierParams(), jmpc, dim=3)
    jctrl = JConnectivityIMPCCBF(
        jop, jcbf.ConnectivityCBF(dmin, dmax, jnp.asarray(jmpc.v_min), jnp.asarray(jmpc.v_max)),
        JIMPCParams(), N, enable_connectivity=True)
    return ctrl, jctrl


CONNECTED = ([0.0, 0.0, 0.0, 0.3, 0.1, 0.0],
             [[1.5, 0.0, 0, 0, 0, 0], [0.0, 1.5, 0, 0, 0, 0], [-1.5, 0.5, 0, 0, 0, 0]], 0.05)
DISCONNECTED = ([0.0, 0.0, 0.0, 0.3, 0.0, 0.0],
                [[5.0, 0.0, 0, 0, 0, 0], [0.0, 5.5, 0, 0, 0, 0], [-6.0, 0.5, 0, 0, 0, 0]], 0.02)


def test_row_lifts_golden_both_branches_in_one_batch():
    """Lane 0 is the well-connected team of
    test_conn_row_lift_golden_connected_branch (λ₂ row = -(a . U_basis[k]),
    ub = b, CLF rows masked), lane 1 the disconnected one of
    test_clf_row_lift_golden_disconnected_branch (CLF rows +(a . U_basis[k]),
    ub = -b, λ₂ rows masked), lane 2 the connected team with neighbor 2
    masked. Every lane equals the JAX controller's dynamic_rows."""
    ctrl, jctrl = _ctrls()
    H, N, n_dec = ctrl.impc.cbf_horizon, ctrl.N, ctrl.op.n_dec
    assert ctrl.m_extra == H * (1 + N) and ctrl.m_dynamic == ctrl.m_cbf + H * (1 + N)
    lanes = [CONNECTED, DISCONNECTED, CONNECTED]
    x = np.array([l[0] for l in lanes])
    nbrs = np.array([l[1] for l in lanes])
    pred = np.stack([np.stack([l[0], np.asarray(l[0]) + l[2]]) for l in lanes])
    mask = np.ones((3, N), bool)
    mask[2, 2] = False
    active = np.ones(H, bool)

    A_d, lb_d, ub_d = ctrl.dynamic_rows(State(T(x[:, :3]), T(x[:, 3:])), T(nbrs),
                                        torch.as_tensor(mask), T(pred), torch.as_tensor(active))
    assert A_d.shape == (3, ctrl.m_dynamic, ctrl.n) and bool((lb_d <= -BIG / 2).all())
    for b in range(3):
        jA, jlb, jub = jctrl.dynamic_rows(
            JState(pos=jnp.asarray(x[b, :3]), vel=jnp.asarray(x[b, 3:])), jnp.asarray(nbrs[b]),
            jnp.asarray(mask[b]), jnp.asarray(pred[b]), jnp.asarray(active))
        np.testing.assert_allclose(A_d[b].numpy(), np.asarray(jA), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ub_d[b].numpy(), np.asarray(jub), rtol=1e-9)

    c, U = ctrl.cbf, ctrl.op.U_basis
    m0 = ctrl.m_cbf
    # lane 0: the λ₂ rows from conn_row, CLF rows masked
    team = T(np.concatenate([x[0][None], nbrs[0]]))
    lam2, vec = c.lambda2(team[:, :2])
    assert float(lam2) > ctrl.LAMBDA2_THRESHOLD
    for k in range(H):
        team_k = torch.cat([T(pred[0, k])[None], team[1:]])
        a_c, b_c = c.conn_row(T(pred[0, k]), team_k, vec, lam2 - c.epsilon, 0)
        np.testing.assert_allclose(A_d[0, m0 + k, :n_dec].numpy(),
                                   -(a_c.numpy() @ U[k * 3:(k + 1) * 3]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(ub_d[0, m0 + k]), float(b_c), rtol=1e-12)
    assert bool((ub_d[0, m0 + H:] >= BIG / 2).all())
    # lane 1: CLF rows with the CBF-only generator's sign, λ₂ rows masked
    lam2_1, _ = c.lambda2(T(np.concatenate([x[1][None], nbrs[1]]))[:, :2])
    assert float(lam2_1) <= ctrl.LAMBDA2_THRESHOLD
    assert bool((ub_d[1, m0:m0 + H] >= BIG / 2).all())
    for k in range(H):
        for j in range(N):
            a, b = c.clf_row(T(pred[1, k]), T(nbrs[1, j]))
            i = m0 + H + k * N + j
            np.testing.assert_allclose(A_d[1, i, :n_dec].numpy(),
                                       a.numpy() @ U[k * 3:(k + 1) * 3], rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(float(ub_d[1, i]), -float(b), rtol=1e-12)


def test_iteration_zero_activates_step_zero_only():
    ctrl, jctrl = _ctrls()
    H = ctrl.impc.cbf_horizon
    x, nbrs, _ = CONNECTED
    x, nbrs = np.asarray(x), np.asarray(nbrs)
    pred = np.broadcast_to(x, (H, 6))
    active = np.arange(H) == 0
    A_d, _, ub_d = ctrl.dynamic_rows(State(T(x[None, :3]), T(x[None, 3:])), T(nbrs[None]),
                                     torch.ones((1, 3), dtype=torch.bool), T(pred[None]),
                                     torch.as_tensor(active))
    jA, _, jub = jctrl.dynamic_rows(JState(pos=jnp.asarray(x[:3]), vel=jnp.asarray(x[3:])),
                                    jnp.asarray(nbrs), jnp.ones(3, bool), jnp.asarray(pred),
                                    jnp.asarray(active))
    np.testing.assert_allclose(A_d[0].numpy(), np.asarray(jA), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ub_d[0].numpy(), np.asarray(jub), rtol=1e-9)
    assert float(ub_d[0, ctrl.m_cbf + 1]) >= BIG / 2       # the λ₂ row of step 1 is off


def test_disabled_flag_keeps_reference_row_count():
    mpc = MPCParams()
    op = BezierMPCOperator(BezierParams(), mpc, dim=3, device="cpu", dtype=F64)
    ctrl = ConnectivityIMPCCBF(op, cbf.ConnectivityCBF(0.5, 4.0, mpc.v_min, mpc.v_max),
                               IMPCParams(), 3)
    assert ctrl.m_extra == 0 and ctrl.m_dynamic == ctrl.m_cbf


# -- the small functions of ops/geometry.py and ops/controls.py


def test_geometry_and_controls_match_jax():
    rng = np.random.default_rng(1)
    pose, tgt = rng.normal(0, 1.5, (64, 3)), rng.normal(0, 1.5, (64, 2))
    got = geometry.inside_fov(T(pose), T(tgt), 2.0, 3.0)
    want = jgeom.inside_fov(jnp.asarray(pose), jnp.asarray(tgt), 2.0, 3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    u, yaw = rng.normal(size=(7, 3)), rng.normal(size=7)
    for name in ("rotate_control_to_body", "rotate_control_to_world"):
        np.testing.assert_allclose(getattr(geometry, name)(T(u), T(yaw)).numpy(),
                                   np.asarray(getattr(jgeom, name)(jnp.asarray(u),
                                                                   jnp.asarray(yaw))),
                                   rtol=0, atol=1e-15)
    pos, vel, goal = rng.normal(size=(3, 7, 3))
    np.testing.assert_allclose(
        controls.critically_damped_spring_control(State(T(pos), T(vel)), T(goal), 2.0).numpy(),
        np.asarray(jcontrols.critically_damped_spring_control(
            JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel)), jnp.asarray(goal), 2.0)),
        rtol=0, atol=1e-14)
    integ, acc = rng.normal(size=(2, 7, 3))
    u_t, i_t = controls.pid_control(controls.PIDParams(1.5, 0.2, 0.7, 0.1), State(T(pos), T(vel)),
                                    T(integ), T(goal), T(vel * 0.5), T(acc))
    u_j, i_j = jcontrols.pid_control(jcontrols.PIDParams(1.5, 0.2, 0.7, 0.1),
                                     JState(pos=jnp.asarray(pos), vel=jnp.asarray(vel)),
                                     jnp.asarray(integ), jnp.asarray(goal),
                                     jnp.asarray(vel * 0.5), jnp.asarray(acc))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0, atol=1e-14)
    np.testing.assert_allclose(i_t.numpy(), np.asarray(i_j), rtol=0, atol=1e-15)
