"""The ported slice end to end on CPU: StructuredIMPC.optimize_batch of
mpc_cbf_torch against mpc_cbf_tpu's (plain lax.scan loop, use_pallas=False)
on the same problems.

Tolerances are those of tests/test_pallas_admm.py:53-61, which holds the
fused loop against the scan loop: coefficients to rtol = atol = 2e-4;
residuals of near-feasible lanes sit at f32 noise, so pri_res to rtol 5e-2
and atol 5e-3; the usable flag equal on every lane.

Connectivity runs in float32. The fov flagship runs in float64 for that
bar: at 60 iterations most fov lanes are far from converged, and there the
f32 ADMM amplifies rounding — the JAX package's own two f32 loops (scan and
Pallas) differ by up to 4.8e-3 on these lanes. The JAX operator keeps its
constants in float32 whatever the input dtype, so the port takes them over
through utils/convert.py and both run the same f64 arithmetic. A float32
fov case holds the usable flags equal and the coefficients to that spread.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mpc_cbf_tpu.types import State as JState
from mpc_cbf_tpu.controllers import StructuredIMPC as JStructuredIMPC
from mpc_cbf_tpu.ops.qp.structured import StructuredConfig as JStructuredConfig

from mpc_cbf_torch.controllers import StructuredIMPC
from mpc_cbf_torch.ops.qp.structured import StructuredConfig
from mpc_cbf_torch.utils import convert

import torch_parity_cases as cases

F32 = torch.float32
CPU = torch.device("cpu")


def _inputs(mode, batch, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    make = cases.fov_inputs if mode == "fov" else cases.conn_inputs
    *floats, mask = make(rng, batch)
    return [np.asarray(a, dtype) for a in floats] + [mask]


def _jax_constants(op_j):
    return dict(D=np.asarray(op_j.D), E_s=np.asarray(op_j.E_s), gamma=op_j.gamma,
                Pb=np.asarray(op_j.Pb), A_sb=np.asarray(op_j.A_sb),
                phases=[(n_it, np.asarray(M), np.asarray(r), rd)
                        for n_it, M, r, rd in op_j.phases])


@functools.lru_cache(maxsize=None)
def _jax_simpc(mode):
    """One JAX driver per mode: its jitted solve is cached per operator."""
    return JStructuredIMPC(cases.jax_controller(mode),
                           JStructuredConfig(iters=60, use_pallas=False))


@functools.lru_cache(maxsize=None)
def _jax_step(mode):
    """The JAX driver's whole step under one jit (as bench.py runs it): one
    compile instead of an eager dispatch per assembly op."""
    simpc = _jax_simpc(mode)
    return jax.jit(lambda pos, vel, *rest, **kw: simpc.optimize_batch(
        JState(pos=pos, vel=vel), *rest, **kw))


def _run_jax(mode, inputs, warm=None, warm_duals=None):
    kw = {}
    if warm is not None:
        kw = dict(warm=jnp.asarray(warm), warm_duals=tuple(map(jnp.asarray, warm_duals)))
    res = _jax_step(mode)(*(jnp.asarray(a) for a in inputs), **kw)
    return _jax_simpc(mode), res


def _run_torch(mode, inputs, warm=None, warm_duals=None, constants=None):
    pos, vel, ref, blob, mask = inputs
    dt = F32 if pos.dtype == np.float32 else torch.float64
    simpc = StructuredIMPC(cases.torch_controller(mode, CPU, dt),
                           StructuredConfig(iters=60))
    if constants is not None:
        convert.set_structured_constants(simpc.op_qp, **constants)
    t = lambda a: convert.to_tensor(a, device=CPU, dtype=dt)
    res = simpc.optimize_batch(
        convert.state_from_numpy(pos, vel, device=CPU, dtype=dt), t(ref), t(blob),
        torch.as_tensor(mask), warm=warm, warm_duals=warm_duals)
    return simpc, res


def _assert_results_match(res_t, res_j):
    np.testing.assert_allclose(res_t.coeffs.numpy(), np.asarray(res_j.coeffs),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res_t.pri_res.numpy(), np.asarray(res_j.pri_res),
                               rtol=5e-2, atol=5e-3)
    np.testing.assert_array_equal(res_t.success.numpy(), np.asarray(res_j.success))


@pytest.mark.parametrize("mode,batch,dtype", [("fov", 6, np.float64),
                                              ("connectivity", 5, np.float32),
                                              ("connectivity_lambda2", 5, np.float64),
                                              ("connectivity_lambda2", 24, np.float32)])
def test_optimize_batch_matches_jax(mode, batch, dtype):
    inputs = _inputs(mode, batch, seed=0, dtype=dtype)
    simpc_j, res_j = _run_jax(mode, inputs)
    _, res_t = _run_torch(mode, inputs, constants=_jax_constants(simpc_j.op_qp))
    assert res_t.coeffs.shape == (batch, 36)
    assert res_t.iterates.shape == (2, batch, 36)
    _assert_results_match(res_t, res_j)
    # The duals are not compared entry by entry: the continuity rows are
    # linearly dependent, so their duals drift along a null space with the
    # rounding of each side (f32 connectivity lanes: 1.4 against -0.06 on
    # one row while the primal agrees to 5e-6). test_warm_duals_round_trip
    # checks what the duals are for, the warm-started next step.
    assert res_t.ys.shape == np.asarray(res_j.ys).shape
    assert res_t.yd.shape == np.asarray(res_j.yd).shape


def test_fov_float32_usable_flags_match():
    """fov in float32: usable flags equal on every lane; coefficients within
    1e-2, above the 4.8e-3 spread between the JAX package's own scan and
    Pallas loops on these lanes."""
    inputs = _inputs("fov", 8, seed=0)
    _, res_j = _run_jax("fov", inputs)
    _, res_t = _run_torch("fov", inputs)
    np.testing.assert_array_equal(res_t.success.numpy(), np.asarray(res_j.success))
    np.testing.assert_allclose(res_t.coeffs.numpy(), np.asarray(res_j.coeffs), atol=1e-2)


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_warm_duals_round_trip(source):
    """A replan step warm-started from the previous step's result. The warm
    primal and duals of one package's result go through utils/convert.py to
    the other package, and both second steps start from the same numbers
    and agree."""
    inputs = _inputs("connectivity", 5, seed=3)
    simpc_j, res_j = _run_jax("connectivity", inputs)
    _, res_t = _run_torch("connectivity", inputs)
    n = simpc_j.ctrl.n
    if source == "jax":
        coeffs, ys, yd = (np.asarray(a) for a in (res_j.coeffs, res_j.ys, res_j.yd))
        warm_np = np.zeros((coeffs.shape[0], n), coeffs.dtype)
        warm_np[:, : coeffs.shape[1]] = coeffs
    else:
        warm_np, ys, yd = convert.warm_start_to_numpy(res_t, n)
        np.testing.assert_array_equal(warm_np[:, :36], res_t.coeffs.numpy())
        np.testing.assert_array_equal(ys, res_t.ys.numpy())
    warm_t, duals_t = convert.warm_start_from_numpy(warm_np[:, :36], ys, yd, n,
                                                    device=CPU, dtype=F32)
    np.testing.assert_array_equal(warm_t.numpy(), warm_np)
    np.testing.assert_array_equal(duals_t[1].numpy(), yd)

    _, res_t2 = _run_torch("connectivity", inputs, warm=warm_t, warm_duals=duals_t)
    _, res_j2 = _run_jax("connectivity", inputs, warm=warm_np, warm_duals=(ys, yd))
    _assert_results_match(res_t2, res_j2)


def test_structured_constants_carried_from_jax():
    """The operator built by the port equals the JAX operator's constants,
    and set_structured_constants installs the JAX ones unchanged."""
    simpc_j = _jax_simpc("fov")
    simpc_t = StructuredIMPC(cases.torch_controller("fov", CPU, torch.float64),
                             StructuredConfig(iters=60))
    op_j, op_t = simpc_j.op_qp, simpc_t.op_qp
    consts = _jax_constants(op_j)
    phases = consts["phases"]
    # the port builds the same constants (the JAX ones are rounded to f32)
    np.testing.assert_allclose(op_t.Ms_inv.numpy(), phases[0][1], rtol=1e-6, atol=1e-6)
    convert.set_structured_constants(op_t, **consts)
    for (n_t, M_t, r_t, rd_t), (n_j, M_j, r_j, rd_j) in zip(op_t.phases, phases):
        assert (n_t, rd_t) == (n_j, rd_j)
        np.testing.assert_array_equal(M_t.numpy(), M_j.astype(np.float64))
        np.testing.assert_array_equal(r_t.numpy(), r_j.astype(np.float64))
    np.testing.assert_array_equal(op_t.D.numpy(), np.asarray(op_j.D, np.float64))
    assert op_t.gamma == op_j.gamma
    with pytest.raises(ValueError):
        convert.set_structured_constants(op_t, **{**consts, "phases": phases[:1]})
