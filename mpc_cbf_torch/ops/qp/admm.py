"""Batched dense OSQP-style ADMM solver (counterpart of
``mpc_cbf_tpu/ops/qp/admm.py``).

Replaces the reference's CPLEX backend (``qpcpp/src/solvers/CPLEX.cpp``):
thousands of QPs run in lockstep, every operation a batched matmul or an
elementwise op over the leading lane axis. The structure-exploiting solver
(``structured.py``, whose loop is the hand-written CUDA kernel) is the
throughput path of the IMPC controllers; this dense module is the
semantics reference, the general-QP solver (arbitrary per-problem P and A)
and what the single-step CBF-QP controllers and the CBF-free MPC run on.
The JAX module is plain jnp outside any Pallas kernel, so this one is plain
PyTorch.

Algorithm (OSQP, Stellato et al. 2020), for
    minimize 0.5 z'Pz + q'z  s.t.  lb <= Az <= ub:

1. Ruiz equilibration of the KKT block [[P, A'], [A, 0]] (fixed number of
   sweeps, no data-dependent control flow).
2. Splitting iterations with per-row rho (equality rows get rho * rho_eq_scale):
       M = P + sigma*I + A' diag(rho) A        (refactorized per rho update)
       x~ = M^{-1} (sigma*x - q + A'(rho.z - y))
       zA = A x~
       x+ = alpha x~ + (1-alpha) x
       z+ = clip(alpha zA + (1-alpha) z + y/rho, lb, ub)
       y+ = y + rho.(alpha zA + (1-alpha) z - z+)
3. A few adaptive-rho rounds: rho <- rho * sqrt(pri_rel / dua_rel), then
   refactorize. The trip counts are fixed, so all lanes stay in lockstep;
   convergence is *reported*, never branched on, and nothing in the loop
   waits for the device.

A lane whose M is not positive definite (``cholesky_ex`` info != 0) gets a
NaN factor, as ``jnp.linalg.cholesky`` gives it: the lane ends NaN with
``converged = False`` and touches no other lane.

Warm starting across MPC steps is first-class (x0/y0 args).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpc_cbf_torch.types import BIG, QPBatch, QPSolution
from mpc_cbf_torch.ops.qp.ipm import chol_factor, chol_solve

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    iters: int = 100            # total splitting iterations
    sigma: float = 1e-6
    rho: float = 0.1
    # boost rho on equality rows. OSQP uses 1e3, but through an f32 Cholesky
    # that pushes cond(M) past what 2 refinement passes recover (the JAX
    # module has the measurement)
    rho_eq_scale: float = 1e2
    alpha: float = 1.6          # over-relaxation
    eps_abs: float = 1e-6
    eps_abs_f32: float = 5e-3   # convergence bar in float32 (f32 ADMM floors ~1e-4)
    rho_updates: int = 3        # outer refactorization rounds (1 = fixed rho)
    refine_steps: int = 2       # iterative-refinement passes on the f32 KKT solve
    ruiz_iters: int = 10        # equilibration sweeps (0 = no scaling)
    rho_min: float = 1e-6
    rho_max: float = 1e6


def _mv(A: Tensor, x: Tensor) -> Tensor:
    """A x for A [B, m, n], x [B, n]."""
    return torch.matmul(A, x[..., None])[..., 0]


def _mtv(A: Tensor, y: Tensor) -> Tensor:
    """A' y for A [B, m, n], y [B, m]."""
    return torch.matmul(y[..., None, :], A)[..., 0, :]


def _amax(x: Tensor) -> Tensor:
    return x.abs().amax(dim=-1)


def _ruiz(P: Tensor, A: Tensor, q: Tensor, iters: int):
    """Ruiz equilibration of [[P, A'],[A, 0]] -> (Pb, Ab, qb, D, E, c) for
    P [B, n, n], A [B, m, n], q [B, n].

    D [B, n] scales variables, E [B, m] scales constraint rows, c [B] scales
    the cost (OSQP §5.1: after the D/E sweeps the cost block is normalized
    by its mean column norm).
    """
    B, m, n = A.shape
    D = P.new_ones((B, n))
    E = P.new_ones((B, m))
    c = P.new_ones((B,))
    Pb, Ab, qb = P, A, q
    for _ in range(iters):
        # column inf-norms of the stacked KKT block
        col_var = torch.maximum(Pb.abs().amax(dim=-2), Ab.abs().amax(dim=-2))   # [B, n]
        col_con = Ab.abs().amax(dim=-1)                                         # [B, m]
        # all-zero rows/cols (masked constraints, padding) stay unscaled:
        # dividing by their ~0 norm overflows f32 across sweeps
        d = torch.where(col_var > 1e-10, torch.rsqrt(col_var.clamp_min(1e-12)),
                        torch.ones_like(col_var))
        e = torch.where(col_con > 1e-10, torch.rsqrt(col_con.clamp_min(1e-12)),
                        torch.ones_like(col_con))
        Pb = d[:, :, None] * Pb * d[:, None, :]
        Ab = e[:, :, None] * Ab * d[:, None, :]
        qb = d * qb
        # cost normalization (the linear term included, so large slack
        # weights do not dwarf the quadratic block)
        gamma = 1.0 / torch.maximum(Pb.abs().amax(dim=-2).mean(dim=-1) + 1e-12, _amax(qb))
        gamma = gamma.clamp_max(1e8)
        Pb = gamma[:, None, None] * Pb
        qb = gamma[:, None] * qb
        D, E, c = D * d, E * e, c * gamma
    return Pb, Ab, qb, D, E, c


def _solve_lanes(P: Tensor, q: Tensor, A: Tensor, lb_in: Tensor, ub_in: Tensor,
                 cfg: ADMMConfig, x0: Tensor, y0: Tensor) -> QPSolution:
    """The ADMM on lanes: P [B, n, n], q [B, n], A [B, m, n], lb/ub [B, m]."""
    n = q.shape[-1]
    dtype = q.dtype
    eq = (ub_in - lb_in) < 1e-12
    inactive = (lb_in <= -BIG / 2) & (ub_in >= BIG / 2)

    Pb, Ab, qb, D, E, c = _ruiz(P, A, q, cfg.ruiz_iters)
    lb = E * lb_in.clamp_min(-BIG)
    ub = E * ub_in.clamp_max(BIG)

    rho_row = torch.where(eq, cfg.rho * cfg.rho_eq_scale, cfg.rho).to(dtype)
    rho_row = torch.where(inactive, 1e-12, rho_row)

    # scale warm starts into the equilibrated space
    x = x0 / D
    y = c[:, None] * y0 / E
    z = torch.clamp(_mv(Ab, x), lb, ub)

    sigma_I = cfg.sigma * torch.eye(n, dtype=dtype, device=q.device)
    AbT = Ab.transpose(-1, -2)

    # iterative refinement recovers ~double the effective precision of the
    # f32 Cholesky solve when cond(M) approaches 1/eps_f32 (singular P +
    # boosted equality rho make that the common case for the MPC QPs)
    refine = cfg.refine_steps if dtype != torch.float64 else 0
    alpha = cfg.alpha

    rounds = max(cfg.rho_updates, 1)
    per_round = max(cfg.iters // rounds, 1)
    for r in range(rounds):
        rho = rho_row
        M = Pb + sigma_I + torch.matmul(AbT * rho[:, None, :], Ab)
        L, ok = chol_factor(M)
        L = torch.where(ok[:, None, None], L, torch.full_like(L, float("nan")))
        for _ in range(per_round):
            rhs = cfg.sigma * x - qb + _mtv(Ab, rho * z - y)
            xt = chol_solve(L, rhs)
            for _ in range(refine):
                xt = xt + chol_solve(L, rhs - _mv(M, xt))
            zA = _mv(Ab, xt)
            x = alpha * xt + (1 - alpha) * x
            z_relax = alpha * zA + (1 - alpha) * z
            z = torch.clamp(z_relax + y / rho, lb, ub)
            y = y + rho * (z_relax - z)
        if r < rounds - 1:
            # OSQP adaptive rho: ratio of scaled residuals
            Ax = _mv(Ab, x)
            Px = _mv(Pb, x)
            Aty = _mtv(Ab, y)
            pri = _amax(Ax - z)
            pri_sc = torch.maximum(_amax(Ax), _amax(z)) + 1e-12
            dua = _amax(Px + qb + Aty)
            dua_sc = torch.maximum(torch.maximum(_amax(Px), _amax(qb)), _amax(Aty)) + 1e-12
            scale = torch.sqrt((pri / pri_sc) / (dua / dua_sc + 1e-18)).clamp(0.1, 10.0)
            new_rho = (rho_row * scale[:, None]).clamp(cfg.rho_min, cfg.rho_max)
            rho_row = torch.where(inactive, 1e-12, new_rho)

    # unscale
    x_out = D * x
    y_out = E * y / c[:, None]
    Ax = _mv(A, x_out)
    viol = (Ax - torch.clamp(Ax, lb_in, ub_in)).abs()      # per-row violation
    pri = viol.amax(dim=-1)
    Px = _mv(P, x_out)
    Aty = _mtv(A, y_out)
    dua = _amax(Px + q + Aty)
    dua_sc = torch.maximum(torch.maximum(_amax(Px), _amax(q)), _amax(Aty).clamp_min(1.0))
    # Primal feasibility is the hard requirement and is checked PER ROW
    # (viol_i <= eps_abs + eps_rel |Ax_i|), so a violated equality row cannot
    # hide behind a large-magnitude CBF row. The dual residual only bounds
    # cost suboptimality, and in f32 it floors near 10-15 % of scale
    # (cancellation in P x + q + A'y at |q| ~ 5e3), so f32 keeps only a coarse
    # dual sanity bar (the JAX module has the measurements).
    if dtype == torch.float64:
        eps_pri_abs, eps_pri_rel, eps_dua = cfg.eps_abs * 10, 1e-5, 1e-3
    else:
        eps_pri_abs, eps_pri_rel, eps_dua = cfg.eps_abs_f32, 1e-3, 0.25
    pri_ok = torch.all(viol <= eps_pri_abs + eps_pri_rel * Ax.abs(), dim=-1)
    return QPSolution(
        z=x_out, y=y_out, pri_res=pri, dua_res=dua,
        converged=pri_ok & (dua < eps_dua * dua_sc) & torch.all(torch.isfinite(x_out), dim=-1))


def solve_batch(qp: QPBatch, cfg: ADMMConfig = ADMMConfig(),
                x0: Optional[Tensor] = None, y0: Optional[Tensor] = None) -> QPSolution:
    """Solve a batch of QPs. Batch axes are all leading axes of qp.q (none:
    one QP); P and A may carry fewer leading axes than q and are then
    shared. Runs where the tensors live, in the dtype of qp.q.

    x0/y0: optional warm starts with the same leading axes.
    """
    batch_shape = qp.q.shape[:-1]
    if x0 is None:
        x0 = torch.zeros_like(qp.q)
    if y0 is None:
        y0 = torch.zeros_like(qp.lb)

    def flat(a: Tensor, k: int) -> Tensor:
        return a.expand(*batch_shape, *a.shape[-k:]).reshape(-1, *a.shape[-k:])

    sol = _solve_lanes(flat(qp.P, 2), flat(qp.q, 1), flat(qp.A, 2), flat(qp.lb, 1),
                       flat(qp.ub, 1), cfg, flat(x0, 1), flat(y0, 1))
    return QPSolution(*(a.reshape(tuple(batch_shape) + tuple(a.shape[1:])) for a in sol))
