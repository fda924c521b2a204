"""The port's deployment layer (mpc_cbf_torch/deploy) against the JAX
package's, on the CPU.

- Bus and Scheduler: the five cases of tests/test_deploy.py, run on both
  packages' classes (pure Python: the same events in the same order).
- One ControlNode replan: the same odom, goal and estimate messages into the
  port's node and the JAX node; the same flyable flag and the curve within
  1e-6, the dense-ADMM bar of tests/test_torch_controllers.py (measured on
  the CPU: 4.9e-13 to 8.9e-13). Both
  controllers run in float64: the JAX node casts its inputs to float32
  before a jitted call that mixes them with float64 constants, so the test
  hands that call the same values widened to float64 (the messages hold
  values that float32 represents exactly).
- The two-robot formation of tests/test_deploy.py on the CPU: both plants
  within 0.5 of their goals after 8 s, the pair never closer than 0.3, and
  the graph refuses a controller on another device or a missing card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mpc_cbf_tpu.deploy as jdeploy
import mpc_cbf_torch.deploy as tdeploy
from mpc_cbf_torch.deploy import launch_formation
from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64
PACKAGES = {"torch": tdeploy, "jax": jdeploy}


def _bus_pubsub_and_latch(pkg):
    bus = pkg.Bus()
    got = []
    bus.publish("a", 1, latch=True)
    bus.subscribe("a", got.append)      # latched delivery on subscribe
    bus.publish("a", 2)
    assert got == [1, 2]


def _scheduler_orders_timers(pkg):
    s = pkg.Scheduler()
    seen = []
    s.create_timer(0.10, lambda: seen.append(("slow", round(s.now, 3))))
    s.create_timer(0.05, lambda: seen.append(("fast", round(s.now, 3))))
    s.run_until(0.2)
    assert seen == [("fast", 0.05), ("slow", 0.1), ("fast", 0.1),
                    ("fast", 0.15), ("slow", 0.2), ("fast", 0.2)]
    assert s.now == 0.2


def _scheduler_cancel(pkg):
    s = pkg.Scheduler()
    seen = []
    ev = s.create_timer(0.1, lambda: seen.append(1))
    s.cancel(ev)
    s.run_until(1.0)
    assert seen == []


def _scheduler_cancel_after_firing(pkg):
    s = pkg.Scheduler()
    seen = []
    ev = s.create_timer(0.1, lambda: seen.append(round(s.now, 3)))
    s.run_until(0.35)
    assert seen == [0.1, 0.2, 0.3]
    s.cancel(ev)
    s.run_until(2.0)
    assert seen == [0.1, 0.2, 0.3]


def _scheduler_cancel_inside_callback(pkg):
    s = pkg.Scheduler()
    seen = []

    def cb():
        seen.append(round(s.now, 3))
        if len(seen) == 2:
            s.cancel(ev)

    ev = s.create_timer(0.1, cb)
    s.run_until(1.0)
    assert seen == [0.1, 0.2]


CASES = [_bus_pubsub_and_latch, _scheduler_orders_timers, _scheduler_cancel,
         _scheduler_cancel_after_firing, _scheduler_cancel_inside_callback]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_bus_and_scheduler(case, pkg):
    case(PACKAGES[pkg])


def _controllers(device="cpu", dtype=F64):
    """(JAX factory, port factory) of tests/test_deploy.py's controller."""
    from mpc_cbf_tpu.ops.cbf import FovCBF as JFovCBF
    from mpc_cbf_tpu.ops.qp import ADMMConfig as JADMMConfig
    from mpc_cbf_tpu import controllers as jc
    from mpc_cbf_torch.ops.cbf import FovCBF
    from mpc_cbf_torch.ops.qp import ADMMConfig
    from mpc_cbf_torch import controllers as tc

    jm, m = jc.MPCParams(), tc.MPCParams()
    jop = jc.BezierMPCOperator(jc.BezierParams(), jm, dim=3)
    jcbf = JFovCBF(2 * np.pi, 0.3, 20.0, jnp.asarray(jm.v_min), jnp.asarray(jm.v_max))
    op = tc.BezierMPCOperator(tc.BezierParams(), m, dim=3, device=device, dtype=dtype)
    cbf = FovCBF(2 * np.pi, 0.3, 20.0, m.v_min, m.v_max)
    return (lambda i: jc.FovIMPCCBF(jop, jcbf, jc.IMPCParams(), max_neighbors=1,
                                    solver=JADMMConfig(iters=200)),
            lambda i: tc.FovIMPCCBF(op, cbf, tc.IMPCParams(), max_neighbors=1,
                                    solver=ADMMConfig(iters=200)))


def _f32(*a):
    return np.asarray(a, np.float32).astype(np.float64)


MESSAGES = {
    "estimate": dict(odom=(_f32(0.25, 0.5, 0.125), _f32(0.5, -0.25, 0.0)),
                     goal=_f32(4.0, 0.75, 0.0),
                     est=(_f32(2.0, 0.5), _f32([0.0625, 0.0078125], [0.0078125, 0.03125]))),
    "close": dict(odom=(_f32(0.0, 0.0, 0.5), _f32(0.0, 0.0, 0.0)),
                  goal=_f32(-3.0, 1.5, 0.0),
                  est=(_f32(0.75, 0.25), _f32([0.25, 0.0], [0.0, 0.25]))),
    "no estimate": dict(odom=(_f32(-1.0, 0.5, 0.0), _f32(0.25, 0.0, 0.0)),
                        goal=_f32(2.0, 2.0, 0.0), est=None),
}


def _replan(pkg, factory, msgs):
    bus, sched = pkg.Bus(), pkg.Scheduler()
    node = pkg.ControlNode("control_0", bus, sched, robot_id=0, controller=factory(0),
                           target_ids=[1], takeoff_time=0.0)
    node.start()
    if pkg is jdeploy:
        # the same numbers the jitted call gets, widened to float64
        impl = node._optimize_impl
        node._jit_optimize = lambda *a: impl(*(jnp.asarray(x, jnp.float64)
                                               if x.dtype == jnp.float32 else x for x in a))
    pos, vel = msgs["odom"]
    bus.publish("robot_0/odom", {"pos": pos, "vel": vel, "t": 0.0})
    bus.publish("robot_0/goal", {"pos": msgs["goal"]}, latch=True)
    if msgs["est"] is not None:
        bus.publish("robot_0/target_1/estimate", {"mean": msgs["est"][0], "cov": msgs["est"][1],
                                                  "t": 0.0})
    node.phase = "MISSION"
    node._optimization_callback()
    return node


@pytest.mark.parametrize("msgs", sorted(MESSAGES))
def test_control_node_replan_matches_jax(msgs):
    jfactory, tfactory = _controllers()
    node = _replan(tdeploy, tfactory, MESSAGES[msgs])
    jnode = _replan(jdeploy, jfactory, MESSAGES[msgs])
    assert (node._curve is None) == (jnode._curve is None)
    assert node._curve is not None and node._curve.shape == (node.controller.op.n_dec,)
    np.testing.assert_allclose(node._curve, np.asarray(jnode._curve), rtol=0, atol=1e-6)
    assert len(node.replan_s) == 1 and node.replan_s[0] > 0
    # the tracker's evaluation matrices on the Ts grid are the JAX node's
    for E, jE in zip(node._E, jnode._E):
        np.testing.assert_allclose(E, jE, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(node._ts_grid, jnode._ts_grid)


def test_two_robot_deployment_reaches_goals():
    """tests/test_deploy.py's formation through the port on the CPU: full
    node graph (SITL plant + particle-filter estimator + controller +
    goal/ids) from takeoff through the mission."""
    _, factory = _controllers(dtype=torch.float32)
    starts = np.array([[0.0, 0.7, 0.0], [4.0, -0.7, 0.0]])
    goals = np.array([[4.0, 0.7, 0.0], [0.0, -0.7, 0.0]])
    bus, sched, nodes = launch_formation(2, starts, goals, factory, takeoff_time=0.5,
                                         filter_rate=10.0, device="cpu")
    sched.run_until(8.0)

    for i, plant in enumerate(nodes["plants"]):
        err = np.linalg.norm(plant._pos[:2] - goals[i][:2])
        assert err < 0.5, (i, plant._pos, goals[i])
    assert all(len(c.path_log) > 100 for c in nodes["controllers"])
    assert all(len(c.replan_s) == 75 for c in nodes["controllers"])
    assert all(len(f._pf) == 1 for f in nodes["filters"])
    p0 = np.asarray(nodes["controllers"][0].path_log)
    p1 = np.asarray(nodes["controllers"][1].path_log)
    n = min(len(p0), len(p1))
    d = np.linalg.norm(p0[:n, :2] - p1[:n, :2], axis=-1)
    assert d.min() > 0.3, d.min()


def test_formation_refuses_a_foreign_device(monkeypatch):
    _, factory = _controllers(dtype=torch.float32)
    starts = np.zeros((2, 3))
    with pytest.raises(ValueError, match="controller on cpu"):
        launch_formation(2, starts, starts, factory, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_formation(2, starts, starts, factory)          # default: the card
