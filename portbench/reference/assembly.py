"""The QP of one replan of one robot, worked out in float64 from the
configuration and the robots' states alone.

Semantics (the upstream C++ controllers, ``FovBezierIMPCCBF.cpp`` and
``ConnectivityIMPCCBF.cpp``, with the fixed-shape conventions the port
documents):

- decision vector: the curve's control points, then one slack per
  neighbour when ``slack_mode`` is on;
- cost: the squared position error of the last ``spd_f`` of ``k_hor``
  predicted positions (a double integrator driven by the curve's sampled
  accelerations) weighted by ``w_pos_err``, plus ``w_u_eff`` times the
  integrated squared 1st..3rd derivatives, plus ranked slack prices
  ``slack_cost * decay**rank`` (nearest neighbour first);
- shared rows: the curve starts at the current position and velocity,
  continuity across pieces, acceleration and velocity limits at the
  horizon's samples, slack >= 0;
- per-robot rows: control barrier rows a . u + b >= 0 per neighbour, family
  and CBF step, lifted through the sampled acceleration as -(a . U_k) z -
  slack <= b, pruned where b > |a|_1 * a_reach (they cannot bind) and
  capped; for the fov controller also a separating plane per neighbour on
  each control point of the first piece.

Everything here is plain PyTorch and numpy: no module of the program is
imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from portbench.reference.bezier import Curve, integrator_rollout

BIG = 1e20                 # a bound at or beyond this is absent
CBF_CAP = 1e6              # bound magnitudes are capped here
VORONOI_EPS = 1e-8
ELLIPSE_S = 4.605          # 90 % confidence scale of the estimate ellipse
F64 = torch.float64


class LaneQP(NamedTuple):
    q: torch.Tensor        # [B, n]
    lb_s: torch.Tensor     # [B, m_s]
    ub_s: torch.Tensor
    A_d: torch.Tensor      # [B, m_d, n]
    lb_d: torch.Tensor     # [B, m_d]
    ub_d: torch.Tensor
    # [B, m_d] rows whose pruning test lies within rounding of its threshold:
    # either outcome is right there
    ambiguous: torch.Tensor
    # [B, m_d] the size of the terms each bound of A_d is a sum of: the
    # scale its rounding is judged against
    ub_scale: torch.Tensor
    # [B, N] lowest and highest rank each neighbour's slack price may take
    # when distances tie within rounding
    rank_lo: torch.Tensor
    rank_hi: torch.Tensor


class Reference:
    """cfg: the configuration file's dict (``base`` is the upstream
    base_config, ``controller`` fov or connectivity, ``robots``)."""

    def __init__(self, cfg: dict, device):
        base = cfg["base"]
        self.kind = cfg["controller"]
        self.R = int(cfg["robots"])
        self.N = self.R - 1
        self.device = device
        mp, lim, bz, cb = (base["mpc_params"], base["physical_limits"], base["bezier_params"],
                           base["cbf_params"])
        self.h, self.K = float(mp["h"]), int(mp["k_hor"])
        tune = mp["mpc_tuning"]
        self.H, self.impc_iter = int(cb["cbf_horizon"]), int(cb["impc_iter"])
        self.S = self.N if cb["slack_mode"] else 0
        self.slack_cost, self.decay = float(cb["slack_cost"]), float(cb["slack_decay_rate"])
        self.a_min, self.a_max = np.asarray(lim["a_min"], float), np.asarray(lim["a_max"], float)
        self.v_min, self.v_max = np.asarray(lim["v_min"], float), np.asarray(lim["v_max"], float)
        self.a_reach = float(max(np.abs(self.a_min).max(), np.abs(self.a_max).max()))
        self.curve = c = Curve(int(bz["num_pieces"]), int(bz["num_control_points"]),
                               float(bz["piece_max_parameter"]), 3)
        self.n_dec = c.n
        self.n = c.n + self.S
        cont = int(bz["bezier_continuity_upto_degree"])
        hs = [k * self.h for k in range(self.K)]
        self.U = c.sample(hs, 2)                                   # [3K, n_dec]
        F, G = integrator_rollout(3, self.h, self.K)
        self.F = F
        self.Phi = G @ self.U
        w = np.zeros(3 * self.K)
        w[3 * (self.K - int(tune["spd_f"])):] = float(tune["w_pos_err"])
        self.w = w
        Q = self.Phi.T @ (w[:, None] * self.Phi)
        for d in range(1, cont + 1):
            Q = Q + float(tune["w_u_eff"]) * c.effort(d)
        P = np.zeros((self.n, self.n))
        P[:c.n, :c.n] = 2.0 * Q
        self.P = P
        # connectivity holds derivatives 0..cont across joints, fov 0..cont-1
        eq = np.concatenate([c.piece_row(0, 0.0, 0), c.piece_row(0, 0.0, 1),
                             c.continuity(cont + 1 if self.kind == "connectivity" else cont)])
        self.n_eq = eq.shape[0]
        rows = [eq, self.U, c.sample(hs, 1)]
        A_s = np.concatenate(rows)
        A_s = np.concatenate([A_s, np.zeros((A_s.shape[0], self.S))], 1)
        if self.S:
            A_s = np.concatenate([A_s, np.concatenate(
                [np.zeros((self.S, c.n)), np.eye(self.S)], 1)])
        self.A_s = A_s
        self.m_s = A_s.shape[0]
        if self.kind == "fov":
            f = base["fov_cbf_params"]
            self.fov = math.radians(float(f["beta"]))
            self.Ds, self.Rs = float(f["Ds"]), float(f["Rs"])
            if self.fov >= math.pi:
                raise ValueError("the reference writes the field-of-view borders for beta < 180")
            self.F_fam = 4
            shape = base["robot_params"]["collision_shape"]
            self.box_half = np.asarray(shape["aligned_box"], float) / 2.0
            self.cp0 = np.stack([c.control_point(0, i) for i in range(c.cps)])  # [P, 3, n]
            self.m_d = self.F_fam * self.H * self.N + self.N * c.cps
            self.cov_diag = float(cfg["estimate_cov_diag"])
        else:
            self.dmin = float(base["cbf_params"]["d_min"])
            self.F_fam = 1
            self.m_d = self.H * self.N
        t = lambda a: torch.as_tensor(a, dtype=F64, device=device)
        self.tP, self.tA_s, self.tU, self.tF = t(self.P), t(self.A_s), t(self.U), t(self.F)
        self.tPhi, self.tw = t(self.Phi), t(self.w)
        self.tUk = t(self.U.reshape(self.K, 3, self.n_dec))
        self.tpredE0 = t(c.sample(hs[:self.H], 0))
        self.tpredE1 = t(c.sample(hs[:self.H], 1))
        if self.kind == "fov":
            self.tcp0, self.tbox = t(self.cp0), t(self.box_half)
        # flying a curve for its a-th period evaluates it at min((a+1) h, end)
        n_ages = max(int(math.ceil(c.duration / self.h - 1e-9)), 1)
        ts = [min((a + 1) * self.h, c.duration) for a in range(n_ages)]
        self.tE0 = t(np.stack([c.sample([x], 0) for x in ts]))     # [ages, 3, n_dec]
        self.tE1 = t(np.stack([c.sample([x], 1) for x in ts]))

    # -- inputs ---------------------------------------------------------------
    @staticmethod
    def closest_yaw(yaw, goal_yaw):
        cands = torch.stack([goal_yaw, goal_yaw + 2 * math.pi, goal_yaw - 2 * math.pi], -1)
        idx = torch.argmin(torch.abs(cands - yaw[..., None]), -1)
        return torch.take_along_dim(cands, idx[..., None], -1)[..., 0]

    def neighbor_mask(self, x, nb):
        if self.kind != "fov":
            return torch.ones(nb.shape[:2], dtype=torch.bool, device=nb.device)
        return torch.linalg.vector_norm(nb[..., :2] - x[:, None, :2], dim=-1) <= self.Rs

    def predicted(self, coeffs):
        """[B, H, 6]: the curve's state at the first H replan times."""
        B = coeffs.shape[0]
        pos = (coeffs @ self.tpredE0.T).reshape(B, self.H, 3)
        vel = (coeffs @ self.tpredE1.T).reshape(B, self.H, 3)
        return torch.cat([pos, vel], -1)

    # -- barrier rows (a . u + b >= 0) -------------------------------------------
    def _fov_rows(self, x, target):
        """(a [F, 3], b [F], |terms of b| [F]) of one state against one
        target xy."""
        tan = math.tan(self.fov / 2)

        def rel(p):
            dx, dy = target[0] - p[0], target[1] - p[1]
            c, s = torch.cos(p[2]), torch.sin(p[2])
            return c * dx + s * dy, -s * dx + c * dy

        def safety(p):
            xr, yr = rel(p)
            return xr * xr + yr * yr - self.Ds ** 2

        def left(p):
            xr, yr = rel(p)
            return tan * xr + yr

        def right(p):
            xr, yr = rel(p)
            return tan * xr - yr

        def reach(p):
            xr, yr = rel(p)
            return self.Rs ** 2 - (xr * xr + yr * yr)

        p, v = x[:3], x[3:]
        alpha = lambda s: 0.1 * s ** 5
        dalpha = lambda s: 0.5 * s ** 4
        a_rows, b_rows, s_rows = [], [], []
        for h_fn in (safety, left, right, reach):
            g = grad(h_fn)(p)
            Hm = hessian(h_fn)(p)
            hv = h_fn(p)
            lfh = g @ v
            terms = (v @ Hm @ v, dalpha(hv) * lfh, alpha(lfh + alpha(hv)))
            a_rows.append(g)
            b_rows.append(sum(terms))
            s_rows.append(sum(t.abs() for t in terms))
        return torch.stack(a_rows), torch.stack(b_rows), torch.stack(s_rows)

    def _conn_rows(self, x, other):
        dx, dy = x[0] - other[0], x[1] - other[1]
        dvx, dvy = x[3] - other[3], x[4] - other[4]
        g = 5.0
        h = dx * dx + dy * dy - self.dmin ** 2
        lfh = 2 * (dx * dvx + dy * dvy)
        lf2h = 2 * (dvx * dvx + dvy * dvy)
        lf_alpha = 3 * g * h * h * (2 * dx * x[3] + 2 * dy * x[4])
        alpha = lambda s: g * s ** 3
        terms = (lf2h, lf_alpha, alpha(lfh + alpha(h)))
        a = torch.stack([2 * dx, 2 * dy, torch.zeros_like(dx)])
        return a[None], sum(terms)[None], sum(t.abs() for t in terms)[None]

    # -- the lane's QP ------------------------------------------------------------
    def lane_qp(self, x, goal, nb, pred, iteration: int) -> LaneQP:
        """x [B, 6] the robot's state; goal [B, 3]; nb [B, N, 6] the other
        robots' states in index order; pred [B, H, 6] the states the CBF rows
        are taken at (the current state in iteration 0, the previous
        iterate's curve after); all float64."""
        B, N, H, Fm = x.shape[0], self.N, self.H, self.F_fam
        dev = x.device
        goal = torch.cat([goal[:, :2], self.closest_yaw(x[:, 2], goal[:, 2])[:, None]], -1)
        ref = goal.repeat(1, self.K)
        q_dec = 2.0 * ((x @ self.tF.T - ref) * self.tw) @ self.tPhi
        nmask = self.neighbor_mask(x, nb)
        # a neighbour at the sensing edge within rounding may be seen or not
        edge = torch.zeros_like(nmask)
        if self.kind == "fov":
            sep = torch.linalg.vector_norm(nb[..., :2] - x[:, None, :2], dim=-1)
            edge = (sep - self.Rs).abs() <= 1e-5 * self.Rs

        # slack prices by distance rank; ties within rounding may go either way
        dist = torch.linalg.vector_norm(nb[..., :2] - x[:, None, :2], dim=-1)
        if self.kind == "fov":     # to the isotropic estimate ellipse's edge
            dist = dist - math.sqrt(ELLIPSE_S * self.cov_diag)
        dist = torch.where(nmask, dist, torch.full_like(dist, math.inf))
        tol = 1e-5 * (1.0 + dist.abs().nan_to_num(posinf=0.0))[:, :, None]
        di, dj = dist[:, :, None], dist[:, None, :]
        both_inf = torch.isinf(di) & torch.isinf(dj)
        idx = torch.arange(N, device=dev)
        below = torch.where(both_inf, idx[None, None, :] < idx[None, :, None], dj < di - tol)
        within = torch.where(both_inf, idx[None, None, :] <= idx[None, :, None],
                             dj <= di + tol)
        rank_lo = below.sum(-1)
        rank_hi = within.sum(-1) - 1
        blur = edge.any(-1, keepdim=True)
        rank_lo = torch.where(blur, torch.zeros_like(rank_lo), rank_lo)
        rank_hi = torch.where(blur, torch.full_like(rank_hi, N - 1), rank_hi)
        rank = torch.argsort(torch.argsort(dist, dim=-1, stable=True), dim=-1)
        q = q_dec
        if self.S:
            q = torch.cat([q_dec, self.slack_cost * self.decay ** rank.to(F64)], -1)

        zeros = x.new_zeros
        t_eq = torch.cat([x[:, :3], x[:, 3:], zeros((B, self.n_eq - 6))], -1)
        lo = torch.as_tensor(np.concatenate([np.tile(self.a_min, self.K),
                                             np.tile(self.v_min, self.K)]), dtype=F64, device=dev)
        hi = torch.as_tensor(np.concatenate([np.tile(self.a_max, self.K),
                                             np.tile(self.v_max, self.K)]), dtype=F64, device=dev)
        lb_s = [t_eq, lo.expand(B, -1)]
        ub_s = [t_eq, hi.expand(B, -1)]
        if self.S:
            lb_s.append(zeros((B, self.S)))
            ub_s.append(x.new_full((B, self.S), BIG))

        # barrier rows at each CBF step h against each neighbour's current state
        xs = pred[:, :, None, :].expand(B, H, N, 6).reshape(-1, 6)
        os_ = nb[:, None, :, :].expand(B, H, N, 6).reshape(-1, 6)
        rows = self._fov_rows if self.kind == "fov" else self._conn_rows
        if self.kind == "fov":
            a, b, bs = vmap(lambda xx, oo: rows(xx, oo[:2]))(xs, os_)
        else:
            a, b, bs = vmap(rows)(xs, os_)
        a = a.reshape(B, H, N, Fm, 3)
        b = b.reshape(B, H, N, Fm)
        bs = bs.reshape(B, H, N, Fm)
        A = -torch.einsum("bhnfd,hdj->bhnfj", a, self.tUk[:H])
        a1 = a.abs().sum(-1) * self.a_reach
        active = torch.zeros(H, dtype=torch.bool, device=dev)
        active[:1 if iteration == 0 else H] = True
        base_mask = active[None, :, None, None] & nmask[:, None, :, None]
        keep = base_mask & (b <= a1)
        ambiguous = (base_mask & ((b - a1).abs() <= 1e-5 * (a1 + b.abs() + 1.0))) \
            | (active[None, :, None, None] & edge[:, None, :, None])
        bs = torch.where(keep, torch.maximum(bs, b.abs()).clamp_min(1.0), torch.ones_like(bs))
        A = torch.where(keep[..., None], A, torch.zeros_like(A))
        b = torch.clamp(torch.maximum(b, -2.0 * a1), -CBF_CAP, CBF_CAP)
        ub = torch.where(keep, b, torch.full_like(b, BIG))
        A = A.reshape(B, H * N * Fm, self.n_dec)
        ub_d, keep = ub.reshape(B, -1), keep.reshape(B, -1)
        amb = ambiguous.reshape(B, -1)
        scales = [bs.reshape(B, -1)]
        if self.S:
            slack = -torch.nn.functional.one_hot(idx, N).to(F64)           # [N, S]
            slack = slack[None, None, :, None, :].expand(B, H, N, Fm, N).reshape(B, -1, N)
            slack = torch.where(keep[..., None], slack, torch.zeros_like(slack))
            A = torch.cat([A, slack], -1)
        A_d, lb_d = [A], [torch.full_like(ub_d, -BIG)]
        ubs, ambs = [ub_d], [amb]
        if self.kind == "fov":
            me = torch.cat([x[:, :2], zeros((B, 1))], -1)
            other = torch.cat([nb[..., :2], zeros((B, N, 1))], -1)
            d = other - me[:, None]
            normal = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-12)
            offset = -(normal * 0.5 * (me[:, None] + other)).sum(-1) \
                + (normal.abs() * self.tbox).sum(-1)
            rows_v = torch.einsum("bnd,pdj->bnpj", normal, self.tcp0)
            P_ = rows_v.shape[2]
            rows_v = torch.where(nmask[:, :, None, None], rows_v, torch.zeros_like(rows_v))
            ub_v = torch.where(nmask[:, :, None], (-offset - VORONOI_EPS)[:, :, None]
                               .expand(B, N, P_), torch.full((B, N, P_), BIG, dtype=F64,
                                                             device=dev))
            rows_v = rows_v.reshape(B, N * P_, self.n_dec)
            if self.S:
                rows_v = torch.cat([rows_v, zeros((B, N * P_, self.S))], -1)
            A_d.append(rows_v)
            lb_d.append(torch.full((B, N * P_), -BIG, dtype=F64, device=dev))
            ubs.append(ub_v.reshape(B, -1))
            ambs.append(edge[:, :, None].expand(B, N, P_).reshape(B, -1))
            scales.append((offset.abs() + 1.0)[:, :, None].expand(B, N, P_).reshape(B, -1))
        return LaneQP(q, torch.cat(lb_s, -1), torch.cat(ub_s, -1), torch.cat(A_d, 1),
                      torch.cat(lb_d, -1), torch.cat(ubs, -1), torch.cat(ambs, -1),
                      torch.cat(scales, -1), rank_lo, rank_hi)

    # -- the closed loop ------------------------------------------------------------
    def fly(self, coeffs, prev_pos, fresh, age, has_curve):
        """The noise-free state after one period: a fresh curve is flown from
        its start, a kept one from the period it has reached (clamped at its
        end); a robot that never had a curve holds still. Returns (pos, vel,
        age, has_curve) before the state noise."""
        n_ages = self.tE0.shape[0]
        idx = torch.where(fresh, torch.zeros_like(age), torch.clamp_max(age, n_ages - 1))
        had = has_curve | fresh
        pos = torch.einsum("bdn,bn->bd", self.tE0[idx], coeffs)
        vel = torch.einsum("bdn,bn->bd", self.tE1[idx], coeffs)
        pos = torch.where(had[:, None], pos, prev_pos)
        vel = torch.where(had[:, None], vel, torch.zeros_like(vel))
        return pos, vel, idx + 1, had
