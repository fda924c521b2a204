"""The small modules of mpc_cbf_torch against their JAX counterparts on the
same inputs (numpy, seeded): the curve helpers of ops/bernstein.py, the
XYYaw double integrator, ops/collision_shapes.py, ops/svm.py, the scoring
helpers of utils/metrics.py, utils/profiling.py and utils/logging.py.

Tolerances: float64 on both sides; the matmul helpers to 1e-12, the SVM
(two ADMM runs, 1000 iterations each) to 1e-6.

One deliberate difference: the JAX package's ``avg_neighbors_in_fov``
counts a robot as its own neighbor wherever atan2 of its signed-zero offset
is 0 (its "drop self" line writes into a copy); the port never does. For
yaws in (0, pi/2) the JAX package counts self at every step, and there the
case below holds port = JAX - 1.
"""

import logging

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpc_cbf_tpu.ops import bernstein as jbz
from mpc_cbf_tpu.ops import collision_shapes as jcs
from mpc_cbf_tpu.ops.svm import hard_margin_svm as jsvm
from mpc_cbf_tpu.models import double_integrator_xyyaw as jxyyaw
from mpc_cbf_tpu.utils import metrics as jmetrics
from mpc_cbf_tpu.utils import logging as jlogging

from mpc_cbf_torch.ops import bernstein as bz
from mpc_cbf_torch.ops import collision_shapes as cs
from mpc_cbf_torch.ops.svm import hard_margin_svm
from mpc_cbf_torch.models import double_integrator_xyyaw
from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils import metrics
from mpc_cbf_torch.utils import logging as tlogging
from mpc_cbf_torch.utils.profiling import StepTimer, annotate, trace

T = torch.from_numpy


@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_eval_curve_and_max_derivative_match_jax(deriv):
    pw = bz.PiecewiseBezier(3, 4, 0.5, 3)
    jpw = jbz.PiecewiseBezier(3, 4, 0.5, 3)
    z = np.random.default_rng(3 + deriv).normal(size=(5, pw.num_decision_variables))
    ts = [0.0, 0.25, 0.7, 1.5]
    np.testing.assert_allclose(bz.eval_curve(pw, T(z), ts, deriv).numpy(),
                               np.asarray(jbz.eval_curve(jpw, jnp.asarray(z), ts, deriv)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(bz.max_derivative_magnitude(pw, T(z), deriv).numpy(),
                               np.asarray(jbz.max_derivative_magnitude(jpw, jnp.asarray(z), deriv)),
                               rtol=1e-12, atol=1e-12)


def test_piecewise_curve_matches_jax():
    pw, jpw = bz.PiecewiseBezier(3, 4, 0.5, 3), jbz.PiecewiseBezier(3, 4, 0.5, 3)
    z = np.random.default_rng(5).normal(size=pw.num_decision_variables)
    c, jc = bz.PiecewiseCurve(pw, T(z)), jbz.PiecewiseCurve(jpw, jnp.asarray(z))
    assert c.max_parameter == jc.max_parameter == 1.5
    for t, deriv in ((0.7, 0), (0.7, 2), (99.0, 1), (-1.0, 0)):     # out of range: clamped
        np.testing.assert_allclose(c.eval(t, deriv).numpy(), np.asarray(jc.eval(t, deriv)),
                                   rtol=0, atol=1e-12)
    assert float(c.max_derivative_magnitude(1)) == pytest.approx(
        float(jc.max_derivative_magnitude(1)), rel=1e-12)


def test_double_integrator_xyyaw_matches_jax():
    m, jm = double_integrator_xyyaw(0.1), jxyyaw(0.1)
    np.testing.assert_array_equal(m.A, jm.A)
    np.testing.assert_array_equal(m.B, jm.B)
    for K in (1, 5):
        for a, b in zip(m.get_A0(K) + m.get_lambda(K), jm.get_A0(K) + jm.get_lambda(K)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    pos, vel, u = rng.normal(size=(3, 4, 3))
    s = m.step(State(T(pos), T(vel)), T(u))
    from mpc_cbf_tpu.types import State as JState
    js = jm.step(JState(jnp.asarray(pos), jnp.asarray(vel)), jnp.asarray(u))
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(js.pos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s.vel.numpy(), np.asarray(js.vel), rtol=0, atol=1e-12)


def test_collision_shapes_match_jax():
    rng = np.random.default_rng(7)
    for dim in (2, 3):
        lo = rng.normal(size=(4, dim))
        hi = lo + rng.uniform(0.1, 2.0, size=(4, dim))
        np.testing.assert_array_equal(cs.corner_points(T(lo), T(hi)).numpy(),
                                      np.asarray(jcs.corner_points(lo, hi)))
        n, o = cs.bounding_hyperplanes(T(lo[0]), T(hi[0]))
        jn, jo = jcs.bounding_hyperplanes(lo[0], hi[0])
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        zero = rng.uniform(0.1, 0.5, size=dim)
        for a, b in zip(cs.buffer_aligned_box(T(lo[0]), T(hi[0]), -zero, zero),
                        jcs.buffer_aligned_box(lo[0], hi[0], -zero, zero)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    normal, offset, pts = rng.normal(size=(5, 2)), rng.normal(size=5), rng.normal(size=(5, 6, 2))
    np.testing.assert_allclose(cs.snap_hyperplane(T(normal), T(offset), T(pts)).numpy(),
                               np.asarray(jcs.snap_hyperplane(jnp.asarray(normal),
                                                              jnp.asarray(offset), jnp.asarray(pts))),
                               rtol=0, atol=1e-12)
    t1, t2, t = np.array(0.5), np.array(2.0), np.array([0.7, 1.9])
    p1, p2 = rng.normal(size=(2, 3))
    np.testing.assert_allclose(
        cs.linear_interpolate(T(t1), T(p1), T(t2), T(p2), T(t)).numpy(),
        np.asarray(jcs.linear_interpolate(t1, p1, t2, p2, t)), rtol=0, atol=1e-12)

    shape = cs.AlignedBoxCollisionShape.from_half_extents([0.5, 0.25, 0.0])
    jshape = jcs.AlignedBoxCollisionShape.from_half_extents([0.5, 0.25, 0.0])
    where = rng.normal(size=(3, 3))
    for a, b in zip(shape.bounding_box(T(where)), jshape.bounding_box(jnp.asarray(where))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(shape.convex_hull_points(T(where)).numpy(),
                                  np.asarray(jshape.convex_hull_points(jnp.asarray(where))))
    np.testing.assert_array_equal(shape.inflate(0.25).half_extents, jshape.inflate(0.25).half_extents)
    assert shape.TYPE == jshape.TYPE


def test_hard_margin_svm_matches_jax():
    rng = np.random.default_rng(11)
    first = rng.normal(size=(6, 2)) + np.array([-2.0, 0.0])
    second = rng.normal(size=(5, 2)) * 0.5 + np.array([2.0, 0.5])
    w, b = hard_margin_svm(T(first), T(second))
    jw, jb = jsvm(first, second)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert float(b) == pytest.approx(float(jb), abs=1e-6)
    # the margin constraints hold (the ADMM's tolerance)
    assert (first @ w.numpy() + float(b)).max() <= -1 + 1e-3
    assert (second @ w.numpy() + float(b)).min() >= 1 - 1e-3


def _trajectories(rng, R=4, T_=30, yaw=(-np.pi, np.pi)):
    traj = np.zeros((R, T_, 3))
    traj[..., :2] = np.cumsum(rng.normal(0, 0.2, size=(R, T_, 2)), axis=1) \
        + 3.0 * rng.normal(size=(R, 1, 2))
    traj[..., 2] = rng.uniform(*yaw, size=(R, T_))
    return traj


@pytest.mark.parametrize("shape_type,shape", [("box", (0.2, 0.2)), ("circle", 0.3)])
def test_scoring_matches_jax(shape_type, shape):
    rng = np.random.default_rng(13)
    for _ in range(6):
        traj = _trajectories(rng)
        goals = traj[:, -1] + rng.normal(0, 0.8, size=(4, 3))
        for radius in (0.5, 1.0):
            kw = dict(radius=radius, collision_shape=shape, shape_type=shape_type)
            assert metrics.instance_success_ref(traj, goals, **kw) == \
                jmetrics.instance_success_ref(traj, goals, **kw)
            assert metrics.instance_success(traj, goals, **kw) == \
                jmetrics.instance_success(traj, goals, **kw)
    bad = _trajectories(rng)
    bad[0, 3, 0] = np.nan
    assert metrics.instance_success_ref(bad, bad[:, -1]) == (False, float("inf"))


def test_avg_neighbors_in_fov_is_jax_without_self():
    rng = np.random.default_rng(17)
    for fov, reach in ((2.0, 5.0), (np.pi, 3.0), (2 * np.pi, 10.0)):
        traj = _trajectories(rng, yaw=(0.05, 1.5))
        assert metrics.avg_neighbors_in_fov(traj, fov, reach) == pytest.approx(
            jmetrics.avg_neighbors_in_fov(traj, fov, reach) - 1.0, abs=1e-12)
    # two robots facing each other inside range: each sees the other
    traj = np.zeros((2, 3, 3))
    traj[1, :, 0] = 2.0
    traj[1, :, 2] = np.pi
    assert metrics.avg_neighbors_in_fov(traj, fov=2.0, rng=5.0) == 1.0


def test_confidence_intervals_match_jax():
    rng = np.random.default_rng(19)
    s = rng.normal(5.0, 1.0, size=(3, 40))
    s_inf = s.copy()
    s_inf[0, ::3] = np.inf
    s_inf[2] = np.inf
    for mine, theirs, x in ((metrics.ci95, jmetrics.ci95, s),
                            (metrics.ci95_with_inf, jmetrics.ci95_with_inf, s_inf),
                            (metrics.percentiles, jmetrics.percentiles, s)):
        for a, b in zip(mine(x), theirs(x)):
            np.testing.assert_array_equal(a, b)


def test_profiling_helpers(tmp_path):
    t = StepTimer()
    assert t.stats() == {}
    for _ in range(10):
        with t.measure():
            torch.ones(8).sum()
    s = t.stats()
    assert s["n"] == 10
    assert 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]
    with trace(str(tmp_path)):
        with annotate("phase"):
            assert float(torch.arange(4).sum()) == 6.0
    assert list(tmp_path.glob("*.json")), "trace wrote no file"


def test_logging_matches_jax(monkeypatch, caplog):
    m = np.arange(6.0).reshape(2, 3) / 7
    assert tlogging.matrix_to_string(m) == jlogging.matrix_to_string(m)
    assert tlogging.matrix_to_string(m[0], precision=3) == jlogging.matrix_to_string(m[0], 3)
    monkeypatch.setenv("SPDLOG_LEVEL", "debug")
    log = tlogging.initialize_logging("mpc_cbf_torch.test")
    assert log.level == logging.DEBUG and len(log.handlers) == 1
    assert tlogging.initialize_logging("mpc_cbf_torch.test").handlers == log.handlers
    with caplog.at_level(logging.INFO, logger="mpc_cbf_torch.test"):
        tlogging.log_matrix(log, "M", m)
        tlogging.log_vector(log, "v", m[1])
    assert "M =\n" + jlogging.matrix_to_string(m) in caplog.text
    assert "v = [0.428571 0.571429 0.714286]" in caplog.text
