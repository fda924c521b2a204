"""A plain primal-dual interior-point solver (Mehrotra predictor-corrector)
for batches of small dense QPs, in float64:

    min 1/2 z'Pz + q'z   s.t.  E z = e,  lb <= A z <= ub

E is shared by the batch; a bound at or beyond ``BIG`` is absent. Each
Newton step solves the reduced KKT system [[P + G'WG, E'], [E, 0]] with an
LU factorization. It runs a fixed number of iterations and reports per lane
whether it met its bars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.assembly import BIG


class Optimum(NamedTuple):
    z: torch.Tensor          # [B, n]
    ok: torch.Tensor         # [B] met the bars: feasible, stationary, complementary
    objective: torch.Tensor  # [B]


def solve(P, q, E, e, A, lb, ub, iters: int = 80, tol: float = 1e-9) -> Optimum:
    """P [n, n]; q [B, n]; E [k, n]; e [B, k]; A [B, m, n]; lb, ub [B, m]."""
    B, n = q.shape
    k = E.shape[0]
    has_u = ub < BIG / 2
    has_l = lb > -BIG / 2
    G = torch.cat([A, -A], 1)                                   # G z + s = h
    h = torch.cat([torch.where(has_u, ub, torch.zeros_like(ub)),
                   torch.where(has_l, -lb, torch.zeros_like(lb))], 1)
    on = torch.cat([has_u, has_l], 1)
    # equilibrate: each inequality row to unit largest entry, the cost to
    # unit largest coefficient (the minimizer does not change)
    row = G.abs().amax(-1)
    on = on & (row > 0)
    row = torch.where(on, row, torch.ones_like(row))
    G = torch.where(on[..., None], G / row[..., None], torch.zeros_like(G))
    h = torch.where(on, h / row, torch.zeros_like(h))
    c = 1.0 / torch.clamp_min(torch.maximum(P.abs().amax().expand(B), q.abs().amax(1)), 1.0)
    P_in, q_in = P, q
    P, q = P * c[:, None, None], q * c[:, None]
    onf = on.to(q.dtype)
    m_on = onf.sum(1).clamp_min(1.0)
    scale = 1.0 + torch.maximum(q.abs().amax(1), h.abs().amax(1))

    Et = E.T.expand(B, n, k)
    zero_kk = q.new_zeros((B, k, k))
    # start from the equality-constrained minimizer of the cost plus the
    # rows' squared residuals
    H0 = P + torch.einsum("bmi,bmj->bij", G, G)
    K0 = torch.cat([torch.cat([H0, Et], 2), torch.cat([Et.mT, zero_kk], 2)], 1)
    rhs0 = torch.cat([-q + torch.einsum("bmn,bm->bn", G, h), e], 1)
    z = torch.linalg.solve_ex(K0, rhs0)[0][:, :n].nan_to_num()
    nu = q.new_zeros((B, k))
    s = torch.where(on, torch.clamp_min(h - torch.einsum("bmn,bn->bm", G, z), 1.0),
                    torch.ones_like(h))
    lam = onf.clone()

    def residuals(z, nu, s, lam):
        Gz = torch.einsum("bmn,bn->bm", G, z)
        r_d = torch.einsum("bij,bj->bi", P, z) + q + nu @ E + torch.einsum("bmn,bm->bn", G, lam)
        r_e = z @ E.T - e
        r_p = (Gz + s - h) * onf
        return r_d, r_e, r_p

    def newton(W, r_d, r_e, r_p, r_c):
        H = P + torch.einsum("bmi,bm,bmj->bij", G, W, G)
        K = torch.cat([torch.cat([H, Et], 2), torch.cat([Et.mT, zero_kk], 2)], 1)
        rhs_z = -r_d - torch.einsum("bmn,bm->bn", G, (W * r_p - r_c / s) * onf)
        sol = torch.linalg.solve_ex(K, torch.cat([rhs_z, -r_e], 1))[0]
        dz, dnu = sol[:, :n], sol[:, n:]
        Gdz = torch.einsum("bmn,bn->bm", G, dz)
        dlam = (W * (Gdz + r_p) - r_c / s) * onf
        ds = (-r_p - Gdz) * onf
        return dz, dnu, ds, dlam

    def step_len(v, dv):
        ratio = torch.where((dv < 0) & on, -v / dv, torch.full_like(v, float("inf")))
        return ratio.amin(1).clamp_max(1.0)

    for _ in range(iters):
        r_d, r_e, r_p = residuals(z, nu, s, lam)
        mu = (s * lam * onf).sum(1) / m_on
        W = lam / s * onf
        # predictor
        dz, dnu, ds, dlam = newton(W, r_d, r_e, r_p, s * lam * onf)
        a_p, a_d = step_len(s, ds), step_len(lam, dlam)
        mu_aff = ((s + a_p[:, None] * ds) * (lam + a_d[:, None] * dlam) * onf).sum(1) / m_on
        sigma = (mu_aff / mu.clamp_min(1e-300)).clamp(0.0, 1.0) ** 3
        # corrector
        r_c = (s * lam + ds * dlam - (sigma * mu)[:, None]) * onf
        dz, dnu, ds, dlam = newton(W, r_d, r_e, r_p, r_c)
        a = 0.99 * torch.minimum(step_len(s, ds), step_len(lam, dlam))
        good = torch.isfinite(dz).all(1) & torch.isfinite(dlam).all(1)
        a = torch.where(good, a, torch.zeros_like(a))[:, None]
        dz, dnu = dz.nan_to_num(), dnu.nan_to_num()
        ds, dlam = ds.nan_to_num(), dlam.nan_to_num()
        z, nu = z + a * dz, nu + a * dnu
        s = torch.where(on, s + a * ds, s)
        lam = torch.where(on, lam + a * dlam, lam)

    # exact step: the rows the iterates hold active (dual above slack) as
    # equalities; the lane is solved when that point is feasible and every
    # active row's multiplier is nonnegative
    act = on & (lam > s)
    Ga = torch.where(act[..., None], G, torch.zeros_like(G))
    eye = torch.diag_embed((~act).to(q.dtype))
    m2 = G.shape[1]
    K = torch.cat([
        torch.cat([P, Et, Ga.mT], 2),
        torch.cat([Et.mT, zero_kk, q.new_zeros((B, k, m2))], 2),
        torch.cat([Ga, q.new_zeros((B, m2, k)), eye], 2)], 1)
    rhs = torch.cat([-q, e, torch.where(act, h, torch.zeros_like(h))], 1)
    sol, info = torch.linalg.solve_ex(K, rhs)
    z_x, lam_x = sol[:, :n], sol[:, n + k:]
    slack_x = h - torch.einsum("bmn,bn->bm", G, z_x)
    ok = ((info == 0) & torch.isfinite(sol).all(1)
          & ((slack_x >= -tol * (1.0 + h.abs())) | ~on).all(1)
          & ((lam_x >= -tol) | ~act).all(1))
    z = torch.where(ok[:, None], z_x, z)
    return Optimum(z, ok, objective(P_in, q_in, z))


def objective(P, q, z):
    return 0.5 * torch.einsum("bi,ij,bj->b", z, P, z) + (q * z).sum(1)


def violation(A, lb, ub, z, row_scale):
    """[B]: the largest violation of lb <= A z <= ub over the rows, each
    divided by its row_scale [B, m]."""
    Az = torch.einsum("bmn,bn->bm", A, z)
    over = torch.where(ub < BIG / 2, Az - ub, torch.zeros_like(Az))
    under = torch.where(lb > -BIG / 2, lb - Az, torch.zeros_like(Az))
    return (torch.maximum(over, under).clamp_min(0.0) / row_scale).amax(1)
