"""``StructuredConfig.lane_chunk`` of mpc_cbf_torch: the whole structured
ADMM solve run over lane slices, the last one shorter where the chunk does
not divide the batch.

Lanes are independent, so the port's chunked solve must equal its
unchunked solve bitwise on the CPU. Against the JAX package the chunked
control step is held to the bars of tests/test_torch_slice.py for one ADMM
control step (coefficients rtol = atol = 2e-4, usable flags equal), in
float64 with the JAX operator's constants carried over, for the reason
given there: far-from-converged fov lanes amplify float32 rounding.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.ops.cbf import FovCBF as JFovCBF
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig
from mpc_cbf_tpu import controllers as jc

from mpc_cbf_torch import controllers as tc
from mpc_cbf_torch.ops.cbf import FovCBF
from mpc_cbf_torch.ops.qp.structured import StructuredConfig, StructuredQPOperator
from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils import convert

import torch_parity_cases as cases
from test_torch_slice import _jax_constants

CPU = torch.device("cpu")
N_NBR = 3


def _problem(rng, B, dtype):
    """The inputs of tests/test_structured.py::
    test_lane_chunked_solve_matches_unchunked, from a numpy generator."""
    pos = rng.normal(0, 0.2, (B, 3))
    vel = rng.normal(0, 0.3, (B, 3))
    goals = rng.normal(0, 2.0, (B, 3))
    ang = rng.uniform(0, 2 * np.pi, (B, N_NBR))
    rad = rng.uniform(2.5, 4.0, (B, N_NBR))
    cov = np.broadcast_to(np.array([0.05, 0.0, 0.05]), (B, N_NBR, 3))
    nbr = np.concatenate([(rad * np.cos(ang))[..., None],
                          (rad * np.sin(ang))[..., None], cov], axis=-1)
    ref = np.tile(goals[:, None, :], (1, cases.MPC_K_HOR, 1)).reshape(B, -1)
    return [np.asarray(a, dtype) for a in (pos, vel, ref, nbr)] + [np.ones((B, N_NBR), bool)]


def _torch_ctrl(dtype):
    mpc = tc.MPCParams()
    op = tc.BezierMPCOperator(tc.BezierParams(), mpc, dim=3, device=CPU, dtype=dtype)
    cbf = FovCBF(cases.FOV_BETA, 1.0, 8.0, mpc.v_min, mpc.v_max)
    return tc.FovIMPCCBF(op, cbf, tc.IMPCParams(slack_mode=True, impc_iter=1), N_NBR,
                         box_half_extents=cases.BOX)


def _torch_step(simpc, inputs, dtype, **kw):
    pos, vel, ref, nbr, mask = inputs
    t = lambda a: convert.to_tensor(a, device=CPU, dtype=dtype)
    return simpc.optimize_batch(State(t(pos), t(vel)), t(ref), t(nbr),
                                torch.as_tensor(mask), **kw)


@pytest.mark.parametrize("warm", [False, True])
def test_chunked_solve_equals_unchunked_bitwise(warm):
    """10 lanes at lane_chunk = 4: chunks of 4, 4 and 2."""
    inputs = _problem(np.random.default_rng(3), 10, np.float32)
    ctrl = _torch_ctrl(torch.float32)
    kw = {}
    if warm:
        first = _torch_step(tc.StructuredIMPC(ctrl, StructuredConfig(iters=30, lane_chunk=0)),
                            inputs, torch.float32)
        warm_t = torch.zeros((10, ctrl.n))
        warm_t[:, :36] = first.coeffs
        kw = dict(warm=warm_t, warm_duals=(first.ys, first.yd))
    full, chunked = (_torch_step(tc.StructuredIMPC(ctrl, StructuredConfig(iters=60, lane_chunk=c)),
                                 inputs, torch.float32, **kw) for c in (0, 4))
    for name in ("coeffs", "pri_res", "success", "ys", "yd"):
        a, b = getattr(full, name), getattr(chunked, name)
        assert a.shape == b.shape and torch.equal(a, b), name


@pytest.mark.parametrize("n,m_d,cfg_chunk,B,expected", [
    (43, 84, None, 32768, 0),       # auto: off below m_d = 128
    (67, 372, None, 32768, 16384),  # auto: 8 GB over 8 (372 67 + 4 67^2) bytes a lane -> 2^14
    (163, 1524, None, 32768, 2048),  # the 128-agent fov lane: 2.8 MB -> 2^11
    (435, 4788, None, 400, 256),    # the 400-agent fov lane (23 MB): at least 256
    (163, 1524, None, 2048, 0),     # the batch fits one chunk
    (163, 1524, None, 2049, 2048),  # a remainder does not turn it off
    (67, 372, 0, 32768, 0),         # 0 = off
    (43, 84, 4, 10, 4),             # k = k lanes, whatever m_d
    (43, 84, 4, 4, 0),              # B <= k: off
])
def test_lane_chunk_rule(n, m_d, cfg_chunk, B, expected):
    """The auto lane_chunk counts the C form's float64 tensors a lane (a copy
    of A_d and four [n, n]), whatever the solve's dtype."""
    op = StructuredQPOperator.__new__(StructuredQPOperator)
    op.n, op.m_d, op.cfg = n, m_d, StructuredConfig(lane_chunk=cfg_chunk)
    assert op._lane_chunk(B) == expected


def test_chunked_control_step_matches_jax():
    """The port at lane_chunk = 4 against the JAX package at lane_chunk = 4
    on 8 lanes (float64, 100 iterations, one IMPC iteration)."""
    B = 8
    inputs = _problem(np.random.default_rng(3), B, np.float64)
    mpc = jc.MPCParams()
    op_j = jc.BezierMPCOperator(jc.BezierParams(), mpc, dim=3)
    cbf_j = JFovCBF(cases.FOV_BETA, 1.0, 8.0, mpc.v_min, mpc.v_max)
    ctrl_j = jc.FovIMPCCBF(op_j, cbf_j, jc.IMPCParams(slack_mode=True, impc_iter=1), N_NBR,
                           box_half_extents=[0.1, 0.1, 0.0])
    simpc_j = jc.StructuredIMPC(ctrl_j, JStructuredConfig(iters=100, lane_chunk=4,
                                                          use_pallas=False))
    pos, vel, ref, nbr, mask = (jnp.asarray(a) for a in inputs)
    res_j = simpc_j.optimize_batch(JState(pos=pos, vel=vel), ref, nbr, mask)

    simpc_t = tc.StructuredIMPC(_torch_ctrl(torch.float64),
                                StructuredConfig(iters=100, lane_chunk=4))
    assert simpc_t.op_qp._lane_chunk(B) == 4
    convert.set_structured_constants(simpc_t.op_qp, **_jax_constants(simpc_j.op_qp))
    res_t = _torch_step(simpc_t, inputs, torch.float64)
    np.testing.assert_allclose(res_t.coeffs.numpy(), np.asarray(res_j.coeffs),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(res_t.success.numpy(), np.asarray(res_j.success))
