"""The 32-robot connectivity team of the benchmark's conn32 configuration
(portbench/configs/conn32.json: the upstream base config with slack on, 32
robots, ``build_sim``'s ADMM) through mpc_cbf_torch on the CPU: the lane
shape it gives, the layout the ``cluster`` kernel takes for it on the card,
one control step through the plain loop whole and in two lane chunks, and
the step's QP and answer against the JAX package's ``build_sim`` on the same
scenario."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_cbf_tpu.apps.run_sim import build_sim as jax_build_sim
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
from mpc_cbf_tpu.types import State as JState

from mpc_cbf_torch.apps.run_sim import build_sim
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.types import State

from test_torch_cluster import register_layout

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
CONN32 = json.loads((ROOT / "portbench" / "configs" / "conn32.json").read_text())
R = CONN32["robots"]


def _sim(solver_cfg=None, dtype=torch.float32):
    sim, _ = build_sim(json.loads(json.dumps(CONN32["base"])), CONN32["controller"], R,
                       CONN32["solver"]["iters"], device=CPU, dtype=dtype)
    return sim if solver_cfg is None else dataclasses.replace(sim, solver_cfg=solver_cfg)


def _ring(seed):
    """One scenario: the 32 robots on benchmarks/swarm.py's ring (2.4 m a
    robot), 0.05 m of start noise, each bound for the next one's start."""
    rng = np.random.default_rng(seed)
    radius = 2.4 * R / (2 * np.pi)
    ang = 2 * np.pi * np.arange(R) / R
    so = np.stack([radius * np.cos(ang), radius * np.sin(ang), (ang + np.pi) % (2 * np.pi)], -1)
    start = so + np.concatenate([rng.normal(0, 0.05, (R, 2)), np.zeros((R, 1))], -1)
    t = lambda a: torch.tensor(a[None], dtype=torch.float32)
    return State(pos=t(start), vel=t(np.zeros((R, 3)))), t(np.roll(so, -1, axis=0))


def test_build_sim_gives_the_conn32_lane():
    """(35 + R, 125 + R, 2R - 2) at R = 32: n above the generic kernel's 64 and
    no folded instance, so the card runs it on the cluster kernel, whose first
    layout that holds it keeps the lane on one SM: its rows in the registers of
    one block of 8 warps (28 rows a warp's strip, 3 column slots), two blocks an
    SM, no cluster."""
    simpc = _sim()._structured_impc()
    op = simpc.op_qp
    assert (op.n, op.m_s, op.m_d) == (67, 157, 62)
    assert not op.wk_form and op._lane_chunk(32 * 1024) == 0
    assert register_layout(67, 157, 62) == (1, 8, (8, 28, 3, True))


def test_control_step_equals_its_two_lane_chunks():
    """One control step of one scenario (32 lanes, both IMPC iterations of 150 +
    50 ADMM iterations) through the plain loop, whole and with the lanes in two
    chunks of 16: lanes are independent, so every output is bit for bit the same."""
    states, goals = _ring(seed=7)
    whole = _sim().control_step(states, goals, return_duals=True)
    split = _sim(StructuredConfig(iters=CONN32["solver"]["iters"], lane_chunk=16))
    assert split._structured_impc().op_qp._lane_chunk(R) == 16
    chunked = split.control_step(states, goals, return_duals=True)
    coeffs, success, flyable, (ys, yd), _ = whole
    assert bool(torch.isfinite(coeffs).all()) and int(success.sum()) >= R // 2
    for a, b in zip((coeffs, success, flyable, ys, yd), chunked[:3] + tuple(chunked[3])):
        assert torch.equal(a, b)


def test_control_step_matches_jax():
    """The same scenario through the JAX package's ``build_sim`` (its plain
    scan loop): the first IMPC iteration's QP of every robot equal to 1e-9 in
    float64, and the float32 step's coefficients within test_torch_slice.py's
    2e-4 with the usable flags equal."""
    jsim, _ = jax_build_sim(json.loads(json.dumps(CONN32["base"])), CONN32["controller"], R,
                            CONN32["solver"]["iters"])
    jsim = dataclasses.replace(jsim, solver_cfg=JStructuredConfig(
        iters=CONN32["solver"]["iters"], use_pallas=False))
    states, goals = _ring(seed=7)
    pos, vel, goal = (np.asarray(a[0], np.float64) for a in (states.pos, states.vel, goals))

    sim64 = _sim(dtype=torch.float64)
    ctrl, jctrl = sim64.controller, jsim.controller
    s64 = State(pos=torch.tensor(pos), vel=torch.tensor(vel))
    blob = sim64._blobs(s64)
    mask = sim64._neighbor_mask(s64, blob)
    H = ctrl.impc.cbf_horizon
    x = np.concatenate([pos, vel], -1)
    pred = np.broadcast_to(x[:, None, :], (R, H, 6))
    active = np.arange(H) == 0
    ref = np.tile(goal, (1, ctrl.op.mpc.k_hor))
    qp = ctrl.assemble(s64, torch.tensor(ref), blob, mask, torch.tensor(pred),
                       torch.as_tensor(active))
    jqp = jax.vmap(lambda p, v, r, b, m, pr: jctrl.assemble(
        JState(pos=p, vel=v), r, b, m, pr, jnp.asarray(active)))(
        *(jnp.asarray(a) for a in (pos, vel, ref, blob.numpy(), mask.numpy(), pred)))
    assert qp.P.shape == (67, 67)                         # the conn32 lane's n
    for name in ("P", "q", "A", "lb", "ub"):
        got, want = getattr(qp, name), np.asarray(getattr(jqp, name))
        got = got.expand(R, *got.shape[-2:]) if name in ("P", "A") else got
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9, err_msg=name)

    coeffs, success, _ = _sim().control_step(states, goals)
    jcoeffs, jsuccess, _ = jax.jit(jsim.control_step)(
        JState(pos=jnp.asarray(states.pos[0].numpy()), vel=jnp.asarray(states.vel[0].numpy())),
        jnp.asarray(goals[0].numpy()))
    np.testing.assert_allclose(coeffs[0].numpy(), np.asarray(jcoeffs), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(success[0].numpy(), np.asarray(jsuccess))
