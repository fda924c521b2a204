"""The C form of the structured ADMM's x-update in mpc_cbf_torch
(``StructuredQPOperator.folded_c``): C = (M_s + A_d' diag(rho_d) A_d)^-1 per
lane in float64, factored by Cholesky, where the JAX package (and the port at
the tiled kernel's three shapes) keeps the Woodbury correction WK.

The factor is held to the product it inverts and to the Woodbury form
(I - WK A_d) Ms_inv, both in float64, with a quarter of the rows masked
(rho = 1e-12, as ``_solve`` masks inactive rows); a lane that is not SPD
comes out NaN and leaves the other lanes bitwise as they were. Then
``StructuredQPOperator.solve`` of the port in the C form is held against the
JAX operator (its plain scan loop) at the shapes of the 32-, 24-, 85- and
8-agent (the fov flagship) fov teams and at a synthetic shape past what the cluster kernel's
first layouts held (n = 420, few rows), in float64, at the bars of
tests/test_torch_slice.py (z to rtol = atol = 2e-4, the converged flags
equal).
"""

import numpy as np
import pytest
import torch

from mpc_cbf_torch.ops.qp import fused_admm
from mpc_cbf_torch.ops.qp.structured import StructuredConfig, StructuredQPOperator

from torch_parity_cases import one_torch_thread  # noqa: F401  (autouse)

F64 = torch.float64


def _phase(rng, B, n, m_d):
    """An SPD M_s [n, n], rows A_d [B, m_d, n] and rho_d with a quarter of the
    rows masked (1e-12), float64."""
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    M_s = 0.5 * np.eye(n) + 0.1 * G @ G.T
    Ad = rng.normal(size=(B, m_d, n)) / np.sqrt(n)
    rho_d = np.where(rng.random((B, m_d)) < 0.25, 1e-12, 0.1)
    return (torch.as_tensor(M_s, dtype=F64), torch.as_tensor(Ad, dtype=F64),
            torch.as_tensor(rho_d, dtype=F64))


@pytest.mark.parametrize("B,n,m_d", [(3, 43, 84), (2, 67, 372), (2, 120, 1008), (2, 160, 12)])
def test_folded_c_inverts_the_product(B, n, m_d):
    M_s, Ad, rho_d = _phase(np.random.default_rng(n), B, n, m_d)
    C = StructuredQPOperator.folded_c(M_s, Ad, rho_d)
    assert C.shape == (B, n, n) and C.dtype == F64
    M = M_s + Ad.mT @ (rho_d[..., None] * Ad)
    eye = torch.eye(n, dtype=F64).expand(B, n, n)
    torch.testing.assert_close(C @ M, eye, rtol=0, atol=1e-10)


@pytest.mark.parametrize("B,n,m_d", [(3, 43, 84), (2, 67, 372), (2, 120, 1008)])
def test_folded_c_equals_the_woodbury_form(B, n, m_d):
    """C = (I - WK A_d) Ms_inv with WK = ``woodbury``'s folded correction (the
    S-scaled inverse of [m_d, m_d], which the masked rows' 1e-12 forced)."""
    M_s, Ad, rho_d = _phase(np.random.default_rng(n + 1), B, n, m_d)
    Ms_inv = torch.linalg.inv(M_s)
    WK = StructuredQPOperator.woodbury(Ms_inv, Ad, rho_d)
    C_wk = (torch.eye(n, dtype=F64) - WK @ Ad) @ Ms_inv
    C = StructuredQPOperator.folded_c(M_s, Ad, rho_d)
    torch.testing.assert_close(C, C_wk, rtol=1e-9, atol=1e-11)


def test_folded_c_of_random_phase_inputs_is_the_woodbury_form():
    """random_phase_inputs' C (the kernels' operand in the tests) is the same
    matrix as (I - WK A_d) Ms_inv of the same draw, to the float32 rounding
    of the inputs."""
    n, m_s, m_d = 67, 151, 372
    c_form = fused_admm.random_phase_inputs(np.random.default_rng(5), 2, n, m_s, m_d)
    wk_form = fused_admm.random_phase_inputs(np.random.default_rng(5), 2, n, m_s, m_d,
                                             operand="wk")
    for i, (a, b) in enumerate(zip(c_form, wk_form)):
        if i != 10:
            np.testing.assert_array_equal(a, b)
    assert c_form[10].dtype == np.float64 and c_form[10].shape == (2, n, n)
    Ms_inv, Ad, WK = (wk_form[i].astype(np.float64) for i in (0, 6, 10))
    np.testing.assert_allclose(c_form[10], (np.eye(n) - WK @ Ad) @ Ms_inv, rtol=0, atol=1e-5)


def test_a_lane_that_is_not_spd_comes_out_nan_alone():
    M_s, Ad, rho_d = _phase(np.random.default_rng(9), 5, 40, 60)
    clean = StructuredQPOperator.folded_c(M_s, Ad, rho_d)
    rho_bad = rho_d.clone()
    rho_bad[2, 0] = -1e6                   # an indefinite product in lane 2
    dirty = StructuredQPOperator.folded_c(M_s, Ad, rho_bad)
    assert bool(torch.isnan(dirty[2]).all())
    keep = torch.arange(5) != 2
    assert torch.equal(clean[keep], dirty[keep])


def _operator_problem(rng, n, m_s, m_d, B):
    """A shared P (SPD), A_s with a tenth equality rows, and B lanes of costs,
    bounds and dynamic rows (a quarter unbounded), all float64."""
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    P = 0.5 * np.eye(n) + G @ G.T
    A_s = rng.normal(size=(m_s, n))
    eq = rng.random(m_s) < 0.1
    q = rng.normal(size=(B, n))
    ub_s = rng.uniform(0.5, 2.0, (B, m_s))
    lb_s = np.where(eq, ub_s, -rng.uniform(0.5, 2.0, (B, m_s)))
    A_d = rng.normal(size=(B, m_d, n))
    free = rng.random((B, m_d)) < 0.25
    ub_d = np.where(free, 1e20, rng.uniform(0.0, 1.0, (B, m_d)))
    lb_d = np.where(free, -1e20, -rng.uniform(0.5, 2.0, (B, m_d)))
    return P, A_s, eq, (q, lb_s, ub_s, A_d, lb_d, ub_d)


@pytest.mark.parametrize("shape", [fused_admm.fov_team_shape(32), fused_admm.fov_team_shape(24),
                                   fused_admm.fov_team_shape(85), (420, 10, 2),
                                   fused_admm.fov_team_shape(8)])
def test_solve_in_the_c_form_matches_jax(shape):
    """The port's operator (C form: none of these shapes is a tiled one; the
    fov team of 8 is the fov flagship (43, 127, 84)) against the JAX
    operator's plain scan loop (Woodbury form) on two lanes, float64, 60
    iterations (40 + 20 over the two rho phases)."""
    import jax.numpy as jnp
    from mpc_cbf_tpu.ops.qp.structured import (StructuredConfig as JStructuredConfig,
                                               StructuredQPOperator as JStructuredQPOperator)
    n, m_s, m_d = shape
    assert not fused_admm.takes_wk(*shape)
    P, A_s, eq, lanes = _operator_problem(np.random.default_rng(n), n, m_s, m_d, 2)
    guards = tuple(range(m_s - 2, m_s))
    op_j = JStructuredQPOperator(P, A_s, eq, m_d, JStructuredConfig(iters=60, use_pallas=False),
                                 dtype=jnp.float64, polish_guard_rows=guards)
    sol_j = op_j.solve(*(jnp.asarray(a) for a in lanes))
    op_t = StructuredQPOperator(P, A_s, eq, m_d, StructuredConfig(iters=60), device="cpu",
                                dtype=F64, polish_guard_rows=guards)
    assert not op_t.wk_form and len(op_t.M_s) == len(op_t.phases) == 2
    sol_t = op_t.solve(*(torch.as_tensor(a, dtype=F64) for a in lanes))
    np.testing.assert_allclose(sol_t.z.numpy(), np.asarray(sol_j.z), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sol_t.pri_res.numpy(), np.asarray(sol_j.pri_res),
                               rtol=5e-2, atol=5e-3)
    np.testing.assert_array_equal(sol_t.converged.numpy(), np.asarray(sol_j.converged))
