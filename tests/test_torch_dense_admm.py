"""The port's dense ADMM (mpc_cbf_torch/ops/qp/admm.py), its row helpers and
the Problem builder against the JAX package, on the QPs of tests/test_qp.py
and the cases of tests/test_problem_builder.py. Both packages get the same
numpy arrays.

Tolerances: float64 z within 1e-8 (the two run the same arithmetic; the
measured spread is ~1e-14), float32 z within 1e-3 with equal `converged`
flags (two f32 factorizations of one matrix; measured ~5e-6).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mpc_cbf_tpu.types import QPBatch as JQPBatch
from mpc_cbf_tpu.ops.qp import ADMMConfig as JADMMConfig, solve_batch as jax_solve
from mpc_cbf_tpu.ops.qp import canon as jcanon
from mpc_cbf_tpu.ops.qp.problem import Problem as JProblem

from mpc_cbf_torch.types import BIG
from mpc_cbf_torch.ops.qp import ADMMConfig, solve_batch, canon
from mpc_cbf_torch.ops.qp.problem import Problem, SolveStatus
from mpc_cbf_torch.utils.convert import qp_batch_from_numpy, qp_solution_to_numpy

DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
Z_TOL = {"f64": 1e-8, "f32": 1e-3}


def _random_qp(seed, n=8, m=12, batch=()):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(*batch, n, n))
    P = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    q = rng.normal(size=(*batch, n))
    A = rng.normal(size=(*batch, m, n))
    z_feas = rng.normal(size=(*batch, n)) * 0.1
    margin = rng.uniform(0.1, 1.0, size=(*batch, m))
    mid = np.einsum("...mn,...n->...m", A, z_feas)
    return P, q, A, mid - margin, mid + margin


def _mpc_scale_qp():
    rng = np.random.default_rng(7)
    n, m = 40, 200
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    z0 = rng.normal(size=n) * 0.1
    lo = A @ z0 - rng.uniform(0.05, 0.5, size=m)
    hi = A @ z0 + rng.uniform(0.05, 0.5, size=m)
    lo[:6] = hi[:6] = (A @ z0)[:6]
    return P, q, A, lo, hi


def _padded_qp():
    A = np.zeros((16, 2))
    A[0] = 1.0
    lb, ub = np.full(16, -BIG), np.full(16, BIG)
    lb[0] = 1.0
    return 2 * np.eye(2), np.zeros(2), A, lb, ub


# (arrays, iterations), the QPs of tests/test_qp.py
QPS = {
    "cplex_smoke": ((2 * np.eye(2), np.zeros(2), np.array([[1.0, 1.0]]),
                     np.array([1.0]), np.array([BIG])), 200),
    "equality": ((2 * np.eye(3), -2 * np.array([3.0, -1.0, 5.0]),
                  np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),
                  np.array([1.0, -2.0]), np.array([1.0, -2.0])), 200),
    "box": ((2 * np.eye(2), np.array([-10.0, 10.0]), np.eye(2), -np.ones(2), np.ones(2)), 200),
    "padded": (_padded_qp(), 200),
    "random0": (_random_qp(0), 400),
    "random1": (_random_qp(1), 400),
    "random2": (_random_qp(2), 400),
    "batched": (_random_qp(3, n=6, m=10, batch=(16,)), 300),
    "two_batch_axes": (_random_qp(4, n=5, m=7, batch=(2, 3)), 200),
    "mpc_scale": (_mpc_scale_qp(), 400),
}


def _both(arrays, iters, prec, x0=None, y0=None):
    tdt, jdt = DTYPES[prec]
    jsol = jax_solve(JQPBatch(*(jnp.asarray(a, jdt) for a in arrays)), JADMMConfig(iters=iters),
                     x0=None if x0 is None else jnp.asarray(x0, jdt),
                     y0=None if y0 is None else jnp.asarray(y0, jdt))
    T = lambda a: None if a is None else torch.as_tensor(a, dtype=tdt)
    tsol = solve_batch(qp_batch_from_numpy(*arrays, device="cpu", dtype=tdt),
                       ADMMConfig(iters=iters), x0=T(x0), y0=T(y0))
    return jsol, qp_solution_to_numpy(tsol)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("name", list(QPS))
def test_solve_batch_matches_jax(name, prec):
    arrays, iters = QPS[name]
    jsol, (z, y, pri, dua, conv) = _both(arrays, iters, prec)
    assert z.shape == arrays[1].shape and y.shape == arrays[3].shape
    assert conv.shape == arrays[1].shape[:-1] == pri.shape == dua.shape
    np.testing.assert_allclose(z, np.asarray(jsol.z), rtol=0, atol=Z_TOL[prec])
    np.testing.assert_array_equal(conv, np.asarray(jsol.converged))
    np.testing.assert_allclose(pri, np.asarray(jsol.pri_res), rtol=0, atol=Z_TOL[prec])
    if prec == "f64":
        assert conv.all()
        np.testing.assert_allclose(y, np.asarray(jsol.y), rtol=0, atol=1e-6)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_warm_start_matches_jax(prec):
    arrays, _ = QPS["batched"]
    jsol, (z, y, *_) = _both(arrays, 300, prec)
    jwarm, (zw, yw, _, _, convw) = _both(arrays, 20, prec, x0=z, y0=y)
    np.testing.assert_allclose(zw, np.asarray(jwarm.z), rtol=0, atol=Z_TOL[prec])
    np.testing.assert_array_equal(convw, np.asarray(jwarm.converged))
    # a few iterations from the solution keep the answer (tests/test_qp.py:108-110)
    np.testing.assert_allclose(zw, z, rtol=0, atol=1e-5 if prec == "f64" else 1e-3)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_non_pd_lane_fails_alone(prec):
    """A lane whose KKT matrix is not positive definite ends NaN and
    unconverged in both packages, and touches no other lane."""
    P, q, A, lb, ub = (a.copy() for a in QPS["batched"][0])
    P[5] = -P[5]
    jsol, (z, _, _, _, conv) = _both((P, q, A, lb, ub), 60, prec)
    _, (z_clean, _, _, _, conv_clean) = _both(QPS["batched"][0], 60, prec)
    assert np.isnan(z[5]).all() and not conv[5]
    assert np.isnan(np.asarray(jsol.z[5])).all() and not bool(jsol.converged[5])
    keep = np.arange(16) != 5
    np.testing.assert_array_equal(z[keep], z_clean[keep])
    np.testing.assert_array_equal(conv[keep], conv_clean[keep])
    np.testing.assert_array_equal(conv, np.asarray(jsol.converged))


def test_shared_P_and_A_are_broadcast():
    """P and A with fewer leading axes than q are shared by the lanes."""
    P, q, A, lb, ub = _random_qp(5)
    rng = np.random.default_rng(6)
    qs = q + rng.normal(size=(4, q.shape[0]))
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    shared = solve_batch(qp_batch_from_numpy(P, qs, A, np.tile(lb, (4, 1)), np.tile(ub, (4, 1)),
                                             device="cpu", dtype=torch.float64),
                         ADMMConfig(iters=200))
    full = solve_batch(qp_batch_from_numpy(np.tile(P, (4, 1, 1)), qs, np.tile(A, (4, 1, 1)),
                                           np.tile(lb, (4, 1)), np.tile(ub, (4, 1)),
                                           device="cpu", dtype=torch.float64),
                       ADMMConfig(iters=200))
    torch.testing.assert_close(shared.z, full.z, rtol=0, atol=0)
    assert shared.z.shape == (4, q.shape[0]) and T(qs).shape == shared.z.shape


def test_canon_helpers_match_jax():
    A, lb, ub = canon.box_rows(3, [-1.0] * 3, [1.0] * 3, dtype=torch.float64, device="cpu")
    jA, jlb, jub = jcanon.box_rows(3, [-1.0] * 3, [1.0] * 3, dtype=jnp.float64)
    rows = [(A, lb, ub), (torch.ones((1, 3), dtype=torch.float64),
                          torch.tensor([0.5], dtype=torch.float64),
                          torch.tensor([BIG], dtype=torch.float64))]
    jrows = [(jA, jlb, jub), (jnp.ones((1, 3)), jnp.asarray([0.5]), jnp.asarray([BIG]))]
    got = canon.pad_rows(*canon.stack_qp(rows), 7)
    want = jcanon.pad_rows(*jcanon.stack_qp(jrows), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        canon.pad_rows(A, lb, ub, 2)
    for g, w in zip(canon.np_pad_rows(np.eye(2), np.zeros(2), np.ones(2), 4),
                    jcanon.np_pad_rows(np.eye(2), np.zeros(2), np.ones(2), 4)):
        np.testing.assert_array_equal(g, w)


# -- Problem: the cases of tests/test_problem_builder.py --------------------


def _cplex_case(p):
    x, y = p.add_variable(), p.add_variable()
    c = p.add_linear_constraint(1.0, 1e20)
    c.set_coefficient(x, 1.0)
    c.set_coefficient(y, 1.0)
    cost = p.cost_function()
    cost.add_quadratic_term(x, x, 1.0)
    cost.add_quadratic_term(y, y, 1.0)


def _bounded_case(p):
    x = p.add_variable(-10.0, 1.0)
    cost = p.cost_function()
    cost.add_quadratic_term(x, x, 1.0)
    cost.add_linear_term(x, -4.0)
    cost.add_constant(4.0)


def _cross_term_case(p):
    x, y = p.add_variable(-1.0, 1.0), p.add_variable(-2.0, 2.0)
    c = p.add_linear_constraint(-0.5, 0.5)
    c.set_coefficient(x, 1.0)
    c.set_coefficient(y, -1.0)
    cost = p.cost_function()
    cost.add_quadratic_term(x, x, 1.0)
    cost.add_quadratic_term(x, y, 0.5)
    cost.add_quadratic_term(y, y, 2.0)
    cost.add_linear_term(y, 3.0)


def _infeasible_case(p):
    x = p.add_variable(0.0, 1.0)
    c = p.add_linear_constraint(5.0, 1e20)  # x >= 5 vs x <= 1
    c.set_coefficient(x, 1.0)
    p.cost_function().add_quadratic_term(x, x, 1.0)


@pytest.mark.parametrize("build", [_cplex_case, _bounded_case, _cross_term_case,
                                   _infeasible_case], ids=lambda f: f.__name__)
def test_problem_matches_jax(build):
    p, jp = Problem(device="cpu"), JProblem()
    build(p)
    build(jp)
    qp, jqp = p.to_qp_batch(), jp.to_qp_batch()
    for name in ("P", "q", "A", "lb", "ub"):
        np.testing.assert_array_equal(getattr(qp, name).numpy(), np.asarray(getattr(jqp, name)))
    status, jstatus = p.solve(), jp.solve()
    assert status.value == jstatus.value
    np.testing.assert_allclose([v.solution_value for v in p.variables()],
                               [v.solution_value for v in jp.variables()], rtol=0, atol=1e-8)
    if build is _cplex_case:
        assert status == SolveStatus.OPTIMAL
        np.testing.assert_allclose([v.solution_value for v in p.variables()], [0.5, 0.5],
                                   atol=1e-5)
    if build is _infeasible_case:
        assert status in (SolveStatus.INFEASIBLE, SolveStatus.UNKNOWN)


def test_problem_bookkeeping():
    p = Problem(device="cpu")
    x = p.add_variable(-1.0, 1.0)
    y = p.add_variable()
    c = p.add_linear_constraint(1.0, 1e20)
    c.set_coefficient(x, 1.0)
    assert c.get_coefficient(x) == 1.0 and c.get_coefficient(y) == 0.0
    cost = p.cost_function()
    cost.add_quadratic_term(x, y, 0.5)
    assert cost.get_quadratic_coefficient(y, x) == 0.5  # symmetric key
    assert (p.num_variables(), p.num_linear_constraints()) == (2, 1)
    p.reset_problem()
    assert (p.num_variables(), p.num_linear_constraints()) == (2, 0)  # variables survive
    assert cost.get_quadratic_coefficient(x, y) == 0.0
