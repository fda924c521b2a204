"""The structured ADMM of the configuration, in plain float64 PyTorch.

The configuration's solver is a fixed-count ADMM (OSQP's splitting) over

    min 1/2 z'Pz + q'z   s.t.  lb_s <= A_s z <= ub_s,  lb_d <= A_d z <= ub_d

with P and A_s shared by every lane and A_d a lane's own rows. Its answer
is defined by the algorithm, not only by the optimum: a lane stops after
its phases' iterations wherever it has reached. So the reference runs the
same algorithm, worked out from the configuration alone:

- equilibration: ten Ruiz passes over the columns of [P; A_s] and the rows
  of A_s; the cost scaled by 1 / max(mean column maximum of the scaled P,
  ``q_scale_hint`` x the median column scale, 1e-12), where the hint is the
  slack price when slacks are on; each dynamic row scaled by one over the
  square root of its largest entry after the column scaling;
- rho: ``rho`` on every row, ``rho * rho_eq_scale`` on the equality rows,
  1e-12 on a dynamic row with no bound; the phases run ``phases[0]``
  iterations soft, then ``phases[1]`` with ``rho_hi_scale`` on the dynamic
  rows and the slack rows (the last ``S`` shared rows); ``sigma`` on the
  primal;
- each iteration: the x-update solves (P + sigma I + A'RA) xt = sigma x - q
  + A'(R z - y) exactly (a Cholesky factor a lane and phase), then
  over-relaxation by ``alpha``, the projection of z onto the bounds and the
  dual step;
- a warm start enters as the primal x0 and the duals ys0, yd0 in unscaled
  row coordinates, and the answer leaves unscaled, with its duals;
- the usable flag's primal residual: each row's violation over max(|row
  value|, 1) in the scaled rows, the largest over the rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.assembly import BIG, Reference

F64 = torch.float64


class AdmmAnswer(NamedTuple):
    z: torch.Tensor          # [B, n]
    rel_pri: torch.Tensor    # [B] the scaled rows' largest relative violation
    ys: torch.Tensor         # [B, m_s] duals, unscaled
    yd: torch.Tensor         # [B, m_d]


class Admm:
    def __init__(self, ref: Reference, solver: dict, device):
        P, A = np.asarray(ref.P, float), np.asarray(ref.A_s, float)
        n, m_s = P.shape[0], A.shape[0]
        d, e = np.ones(n), np.ones(m_s)
        Ps, As = P.copy(), A.copy()
        for _ in range(10):
            col = np.maximum(np.abs(Ps).max(0), np.abs(As).max(0))
            dn = np.where(col > 1e-10, 1.0 / np.sqrt(col), 1.0)
            Ps = dn[:, None] * Ps * dn[None, :]
            As = As * dn[None, :]
            row = np.abs(As).max(1)
            en = np.where(row > 1e-10, 1.0 / np.sqrt(row), 1.0)
            As = en[:, None] * As
            d, e = d * dn, e * en
        hint = ref.slack_cost if ref.S else 0.0
        gamma = 1.0 / max(np.abs(Ps).max(0).mean(), hint * np.median(d), 1e-12)
        Ps = Ps * gamma
        eq = np.arange(m_s) < ref.n_eq
        slack_row = np.arange(m_s) >= m_s - ref.S
        self.sigma, self.alpha = float(solver["sigma"]), float(solver["alpha"])
        rho = float(solver["rho"])
        self.phases = []
        for scale, iters in zip((1.0, float(solver["rho_hi_scale"])), solver["phases"]):
            rho_s = np.where(eq, rho * float(solver["rho_eq_scale"]), rho) \
                * np.where(slack_row, scale, 1.0)
            M_s = Ps + self.sigma * np.eye(n) + (As.T * rho_s) @ As
            self.phases.append((int(iters), rho_s, rho * scale, M_s))
        t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
        self.D, self.E, self.gamma = t(d), t(e), float(gamma)
        self.A = t(As)
        self.phases = [(it, t(rs), rd, t(M)) for it, rs, rd, M in self.phases]

    def solve(self, q, lb_s, ub_s, A_d, lb_d, ub_d, x0: Optional[torch.Tensor] = None,
              ys0: Optional[torch.Tensor] = None, yd0: Optional[torch.Tensor] = None,
              low=None) -> AdmmAnswer:
        """All [B, ...] float64, the bounds with BIG for none. low: a
        rounding applied to both operands of every product with the rows
        (A_s, A_d), the x-update's solve left in float64."""
        r = low if low is not None else (lambda t: t)
        D, E, A = self.D, self.E, self.A
        qb = q * D * self.gamma
        lbs, ubs = lb_s.clamp_min(-BIG) * E, ub_s.clamp_max(BIG) * E
        Ad = A_d * D
        norm = Ad.abs().amax(-1)
        e_d = torch.where(norm > 1e-10, 1.0 / norm.sqrt(), torch.ones_like(norm))
        Ad = Ad * e_d[..., None]
        lbd, ubd = lb_d.clamp_min(-BIG) * e_d, ub_d.clamp_max(BIG) * e_d
        free = (lb_d <= -BIG / 2) & (ub_d >= BIG / 2)

        rA, rAd = r(A), r(Ad)
        x = torch.zeros_like(q) if x0 is None else x0 / D
        zs = torch.clamp(r(x) @ rA.T, lbs, ubs)
        zd = torch.clamp(torch.einsum("bdj,bj->bd", rAd, r(x)), lbd, ubd)
        ys = torch.zeros_like(zs) if ys0 is None else ys0 * self.gamma / E
        yd = torch.zeros_like(zd) if yd0 is None else yd0 * self.gamma / e_d
        a = self.alpha
        for iters, rho_s, rho_d0, M_s in self.phases:
            rho_d = torch.where(free, torch.full_like(e_d, 1e-12), torch.full_like(e_d, rho_d0))
            M = M_s + torch.einsum("bdi,bd,bdj->bij", Ad, rho_d, Ad)
            L = torch.linalg.cholesky(M)
            for _ in range(iters):
                rhs = self.sigma * x - qb + r(rho_s * zs - ys) @ rA \
                    + torch.einsum("bdj,bd->bj", rAd, r(rho_d * zd - yd))
                xt = torch.cholesky_solve(rhs[..., None], L)[..., 0]
                us = a * (r(xt) @ rA.T) + (1 - a) * zs
                ud = a * torch.einsum("bdj,bj->bd", rAd, r(xt)) + (1 - a) * zd
                x = a * xt + (1 - a) * x
                zs_new = torch.clamp(us + ys / rho_s, lbs, ubs)
                zd_new = torch.clamp(ud + yd / rho_d, lbd, ubd)
                ys = ys + rho_s * (us - zs_new)
                yd = yd + rho_d * (ud - zd_new)
                zs, zd = zs_new, zd_new
        Ax_s = x @ A.T
        Ax_d = torch.einsum("bdj,bj->bd", Ad, x)
        rel = torch.maximum(
            ((Ax_s - Ax_s.clamp(lbs, ubs)).abs() / Ax_s.abs().clamp_min(1.0)).amax(-1),
            ((Ax_d - Ax_d.clamp(lbd, ubd)).abs() / Ax_d.abs().clamp_min(1.0)).amax(-1))
        return AdmmAnswer(D * x, rel, ys * E / self.gamma, yd * e_d / self.gamma)


def shift_matrix(ref: Reference) -> torch.Tensor:
    """[n_dec, n_dec] S with S c the coefficients of the least-squares fit,
    on 8 points a piece, of the curve c advanced by one period h (held at
    its end): the primal warm start of the next replan is S c."""
    c = ref.curve
    ts = np.linspace(0.0, c.duration, 8 * c.pieces + 1)
    E = c.sample(list(ts), 0)
    Esh = c.sample([min(t + ref.h, c.duration) for t in ts], 0)
    S, *_ = np.linalg.lstsq(E, Esh, rcond=None)
    return torch.as_tensor(S, dtype=F64, device=ref.device)
