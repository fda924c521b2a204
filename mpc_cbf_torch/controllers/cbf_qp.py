"""Single-step CBF-QP controllers, the reference's "CBF-only" family
(counterpart of ``mpc_cbf_tpu/controllers/cbf_qp.py``).

Reference parity:
- FovControl:           ``cbf/src/controller/FovControl.cpp:17-90``
- ConnectivityControl:  ``cbf/src/controller/ConnectivityControl.cpp:22-99``
- QP assembly:          ``cbf/src/optimization/{CBFQPGeneratorBase,
  FovQPGenerator,ConnectivityQPGenerator}.cpp``

QP layout (n = DIM + S variables, DIM=3 control + S slack):
    minimize ||u - u_des||^2 + sum_i w_i s_i
    s.t.     -a_c . u - s_{c} <= b_c     per CBF constraint row c
             s >= 0, control bounds (Fov only; ConnectivityControl.cpp:62
             has them commented out)

Everything is fixed-shape: a controller is built for a maximum neighbor
count; per-step neighbor masks deactivate rows. Every method takes a batch
of lanes ([B, ...], one lane per robot of every scenario) and solves them
with one call of the batched dense ADMM; only the autodiff CBF rows go
through ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from mpc_cbf_torch.types import BIG, QPBatch
from mpc_cbf_torch.ops.cbf import FovCBF, ConnectivityCBF
from mpc_cbf_torch.ops.geometry import distance_to_ellipse
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch
from mpc_cbf_torch.controllers.mpc_cbf import CBF_BOUND_CAP
from mpc_cbf_torch.controllers.mpc_cbf import _rank_weights as _rank_by_distance

Tensor = torch.Tensor


def _rank_weights(distances: Tensor, mask: Tensor, w_init: float, decay: float) -> Tensor:
    """Slack weights by closeness rank over the last axis: nearest neighbor
    gets w_init, k-th nearest w_init * decay^k (FovControl.cpp:31-49).
    Masked neighbors sort last and get (unused) tail weights; the sort is
    stable, so ties rank by index."""
    d = torch.where(mask, distances, torch.full_like(distances, float("inf")))
    return _rank_by_distance(d, w_init, decay)


def _slack_padded(a_rows: Tensor, n_slack: int, slack_idx: Tensor) -> Tensor:
    """Append slack columns to a_rows [..., m, 3]: -1 at slack_idx [..., m]
    per row, zeros elsewhere (and a zero row for an index outside
    [0, n_slack), as ``jax.nn.one_hot`` gives)."""
    cols = slack_idx[..., None] == torch.arange(n_slack, device=a_rows.device)
    cols = cols.to(a_rows.dtype).expand(*a_rows.shape[:-1], n_slack)
    return torch.cat([a_rows, -cols], dim=-1)


def _cost(desired_u: Tensor, n: int):
    """(P [n, n], q [B, n]) of ||u - u_des||^2 with zero slack weights."""
    P = desired_u.new_zeros((n, n))
    P[:3, :3] = 2.0 * torch.eye(3, dtype=P.dtype, device=P.device)
    q = torch.cat([-2.0 * desired_u, desired_u.new_zeros((desired_u.shape[0], n - 3))], dim=-1)
    return P, q


class CBFControlResult(NamedTuple):
    u: Tensor
    slack: Tensor
    converged: Tensor
    pri_res: Tensor


def _result(sol) -> CBFControlResult:
    return CBFControlResult(u=sol.z[..., :3], slack=sol.z[..., 3:],
                            converged=sol.converged, pri_res=sol.pri_res)


class FovCBFController:
    """Batched FovControl: QP over u in R^3 (+slacks) with 4 CBF rows per
    neighbor + velocity rows + control bounds."""

    def __init__(self, cbf: FovCBF, max_neighbors: int, slack_mode: bool = False,
                 slack_cost: float = 50000.0, slack_decay_rate: float = 0.1,
                 u_min=None, u_max=None,
                 solver: ADMMConfig = ADMMConfig(iters=200)):
        self.cbf = cbf
        self.N = max_neighbors
        self.slack_mode = slack_mode
        self.S = max_neighbors if slack_mode else 0
        self.slack_cost = slack_cost
        self.slack_decay = slack_decay_rate
        self.u_min = np.asarray(u_min, np.float64) if u_min is not None else None
        self.u_max = np.asarray(u_max, np.float64) if u_max is not None else None
        self.solver = solver
        self._bounds = {}

    @property
    def n(self) -> int:
        return 3 + self.S

    def _box(self, like: Tensor):
        """(lo, hi) [n] of the identity rows (control bounds, slack >= 0)
        on like's device in its dtype, made once."""
        key = (like.device, like.dtype)
        if key not in self._bounds:
            lo, hi = np.full(self.n, -BIG), np.full(self.n, BIG)
            if self.u_min is not None:
                lo[:3] = self.u_min
            if self.u_max is not None:
                hi[:3] = self.u_max
            lo[3:] = 0.0
            self._bounds[key] = (like.new_tensor(lo), like.new_tensor(hi))
        return self._bounds[key]

    def _rows_for_neighbor(self, state: Tensor, t_xy: Tensor):
        a_s, b_s = self.cbf.safety_row(state, t_xy)
        a_l, b_l = self.cbf.lb_row(state, t_xy)
        a_r, b_r = self.cbf.rb_row(state, t_xy)
        a_g, b_g = self.cbf.range_row(state, t_xy)
        return torch.stack([a_s, a_l, a_r, a_g]), torch.stack([b_s, b_l, b_r, b_g])

    def assemble(self, state: Tensor, desired_u: Tensor, neighbor_xy: Tensor,
                 neighbor_cov: Tensor, neighbor_mask: Tensor) -> QPBatch:
        """Build each lane's QP. state [B, 6]; desired_u [B, 3]; neighbor_xy
        [B, N, 2]; neighbor_cov [B, N, 2, 2]; neighbor_mask [B, N] bool.
        P [n, n] is shared by the lanes."""
        N, S, n = self.N, self.S, self.n
        B = state.shape[0]

        # cost: ||u - u_des||^2 (+ linear slack cost)
        P, q = _cost(desired_u, n)
        if self.slack_mode:
            dists = distance_to_ellipse(state[:, None, :2], neighbor_xy, neighbor_cov)
            w = _rank_weights(dists, neighbor_mask, self.slack_cost, self.slack_decay)
            q = torch.cat([q[:, :3], w], dim=-1)

        # CBF rows: per neighbor [safety, lb, rb, range]
        A_nbr, b_nbr = vmap(self._rows_for_neighbor)(
            state[:, None, :].expand(B, N, 6).reshape(B * N, 6), neighbor_xy.reshape(B * N, 2))
        A_cbf = (-A_nbr).reshape(B, 4 * N, 3)   # generator negates (FovQPGenerator.cpp:17)
        # cap alpha-composition bounds for f32 (see mpc_cbf.CBF_BOUND_CAP)
        ub_cbf = torch.clamp(b_nbr.reshape(B, 4 * N), -CBF_BOUND_CAP, CBF_BOUND_CAP)
        row_mask = neighbor_mask.repeat_interleave(4, dim=-1)
        # prune provably-inactive rows: |a . u| <= ||a||_1 * u_reach given
        # the control-bound rows below (far-neighbor alpha compositions
        # produce b ~ 1e4+, which wrecks f32 ADMM row scaling)
        if self.u_max is not None or self.u_min is not None:
            hi = np.max(np.abs(self.u_max)) if self.u_max is not None else np.inf
            lo = np.max(np.abs(self.u_min)) if self.u_min is not None else np.inf
            u_reach = float(max(hi, lo))
            a_l1 = torch.sum(torch.abs(A_cbf), dim=-1)
            row_mask = row_mask & (ub_cbf <= a_l1 * u_reach)
        A_cbf = torch.where(row_mask[..., None], A_cbf, torch.zeros_like(A_cbf))
        ub_cbf = torch.where(row_mask, ub_cbf, torch.full_like(ub_cbf, BIG))
        if self.slack_mode:
            slack_idx = torch.arange(N, device=state.device).repeat_interleave(4)
            A_cbf = _slack_padded(A_cbf, S, slack_idx)
            A_cbf = torch.where(row_mask[..., None], A_cbf, torch.zeros_like(A_cbf))

        # velocity rows (relative degree 1): -a . u <= b
        A_vel_u, b_vel = vmap(self.cbf.vel_rows)(state)
        A_vel = torch.cat([-A_vel_u, state.new_zeros((B, 6, S))], dim=-1)

        # control bounds + slack nonnegativity as identity rows
        lo, hi = self._box(state)
        eye = torch.eye(n, dtype=state.dtype, device=state.device)
        big = state.new_full((B, 4 * N + 6), -BIG)
        return QPBatch(
            P=P, q=q,
            A=torch.cat([A_cbf, A_vel, eye.expand(B, n, n)], dim=1),
            lb=torch.cat([big, lo.expand(B, n)], dim=-1),
            ub=torch.cat([ub_cbf, b_vel, hi.expand(B, n)], dim=-1),
        )

    def control(self, state: Tensor, desired_u: Tensor, neighbor_xy: Tensor,
                neighbor_cov: Tensor, neighbor_mask: Tensor,
                warm: Optional[Tuple[Tensor, Tensor]] = None) -> CBFControlResult:
        qp = self.assemble(state, desired_u, neighbor_xy, neighbor_cov, neighbor_mask)
        x0, y0 = warm if warm is not None else (None, None)
        return _result(solve_batch(qp, self.solver, x0=x0, y0=y0))


class ConnectivityCBFController:
    """Batched ConnectivityControl: pairwise safety + (lambda2 CBF | CLF
    fallback) + velocity rows (ConnectivityControl.cpp:22-99).

    Built for a fixed robot count `num_robots`; a lane is one robot
    (self_idx) of one team. The reference's data-dependent branch
    (lambda2 > 0.1 ? conn : CLF, :71-84) becomes row masking so all lanes
    stay in one lockstep program.
    """

    LAMBDA2_THRESHOLD = 0.1  # ConnectivityControl.cpp:70-72

    def __init__(self, cbf: ConnectivityCBF, num_robots: int, slack_mode: bool = False,
                 slack_cost: float = 50000.0, slack_decay_rate: float = 0.1,
                 solver: ADMMConfig = ADMMConfig(iters=200)):
        self.cbf = cbf
        self.R = num_robots
        self.slack_mode = slack_mode
        self.S = num_robots if slack_mode else 0
        self.slack_cost = slack_cost
        self.slack_decay = slack_decay_rate
        self.solver = solver

    @property
    def n(self) -> int:
        return 3 + self.S

    def assemble(self, robot_states: Tensor, self_idx: Tensor, desired_u: Tensor,
                 lam2_eigvec=None) -> QPBatch:
        """robot_states [B, R, 6] (each lane's team); self_idx [B] int64;
        desired_u [B, 3]. P [n, n] is shared by the lanes.

        lam2_eigvec: optional precomputed (lambda2 [B], eigvec [B, R]) of
        each lane's TEAM. It is a per-team quantity, so callers with one
        lane per robot should compute it ONCE per team and pass it in
        (control_all does); left inside for single-robot parity with
        ConnectivityControl.cpp:69.
        """
        R, S, n = self.R, self.S, self.n
        B = robot_states.shape[0]
        dev = robot_states.device
        is_self = torch.arange(R, device=dev) == self_idx[:, None]               # [B, R]
        state = torch.sum(torch.where(is_self[..., None], robot_states,
                                      torch.zeros_like(robot_states)), dim=1)     # [B, 6]

        P, q = _cost(desired_u, n)
        if self.slack_mode:
            # index-decayed weights (ConnectivityControl.cpp:33-40)
            w = self.slack_cost * self.slack_decay ** torch.arange(
                S, dtype=q.dtype, device=dev)
            q = torch.cat([q[:, :3], w.expand(B, S)], dim=-1)

        # lambda2 of the whole team (hoisted by control_all)
        lam2, eigvec = (self.cbf.lambda2(robot_states[..., :2])
                        if lam2_eigvec is None else lam2_eigvec)
        h_val = lam2 - self.cbf.epsilon
        use_conn = lam2 > self.LAMBDA2_THRESHOLD                                  # [B]

        # pairwise safety rows vs every other robot; the generator negates
        # (ConnectivityQPGenerator.cpp:77-83)
        ego = state[:, None, :].expand(B, R, 6).reshape(B * R, 6)
        nbrs = robot_states.reshape(B * R, 6)
        a_saf, b_saf = vmap(self.cbf.safety_row)(ego, nbrs)
        A_saf = -a_saf.reshape(B, R, 3)
        b_saf = torch.clamp(b_saf.reshape(B, R), -CBF_BOUND_CAP, CBF_BOUND_CAP)
        A_saf = torch.where(is_self[..., None], torch.zeros_like(A_saf), A_saf)
        b_saf = torch.where(is_self, torch.full_like(b_saf, BIG), b_saf)
        # prune provably-inactive far-neighbor rows: the velocity-barrier
        # rows imply |u_d| <= (vmax - vmin)_d (relative-degree-1, alpha=id),
        # so b beyond ||a||_1 * u_reach can never bind (f32 ADMM scaling)
        u_reach = float(np.max(np.abs(self.cbf.vmax - self.cbf.vmin)))
        a_l1 = torch.sum(torch.abs(A_saf), dim=-1)
        b_saf = torch.where(b_saf > a_l1 * u_reach, torch.full_like(b_saf, BIG), b_saf)
        # slack idx for neighbor j: its position among non-self robots (-1
        # for the ego when it is robot 0: no slack column, its row is zero)
        nbr_ord = torch.cumsum((~is_self).to(torch.int64), dim=-1) - 1
        zeros_S = robot_states.new_zeros((B, R, S))
        if S:
            A_saf = _slack_padded(A_saf, S, nbr_ord)
            A_saf = torch.where(is_self[..., None], torch.zeros_like(A_saf), A_saf)
        else:
            A_saf = torch.cat([A_saf, zeros_S], dim=-1)

        # connectivity row (active when lambda2 > threshold)
        a_c, b_c = vmap(self.cbf.conn_row)(state, robot_states, eigvec, h_val, self_idx)
        A_conn = torch.cat([-a_c, a_c.new_zeros((B, S))], dim=-1)
        if S:   # last slack (ConnectivityQPGenerator.cpp:36)
            A_conn = torch.cat([A_conn[:, :-1], a_c.new_full((B, 1), -1.0)], dim=-1)
        ub_conn = torch.where(use_conn, b_c, torch.full_like(b_c, BIG))[:, None]
        A_conn = torch.where(use_conn[:, None], A_conn, torch.zeros_like(A_conn))[:, None, :]

        # CLF rows per neighbor (active when lambda2 <= threshold);
        # NOTE sign: coefficients are +a, bound is -b
        # (ConnectivityQPGenerator.cpp:47-55). The ego's own row is NaN
        # (zero distance) and is masked on its value.
        a_clf, b_clf = vmap(self.cbf.clf_row)(ego, nbrs)
        clf_mask = (~is_self) & (~use_conn)[:, None]
        A_clf = torch.where(clf_mask[..., None], a_clf.reshape(B, R, 3),
                            a_clf.new_zeros((B, R, 3)))
        ub_clf = torch.where(clf_mask, -b_clf.reshape(B, R), b_clf.new_full((B, R), BIG))
        if S:
            A_clf = _slack_padded(A_clf, S, nbr_ord)
            A_clf = torch.where(clf_mask[..., None], A_clf, torch.zeros_like(A_clf))
        else:
            A_clf = torch.cat([A_clf, zeros_S], dim=-1)

        # velocity rows
        A_vel_u, b_vel = vmap(self.cbf.vel_rows)(state)
        A_vel = torch.cat([-A_vel_u, robot_states.new_zeros((B, 6, S))], dim=-1)

        blocks_A = [A_saf, A_conn, A_clf, A_vel]
        blocks_lb = [robot_states.new_full((B, 2 * R + 7), -BIG)]
        blocks_ub = [b_saf, ub_conn, ub_clf, b_vel]

        # slack nonnegativity (no control bounds: ConnectivityControl.cpp:62)
        if S:
            eye_s = torch.cat([robot_states.new_zeros((S, 3)),
                               torch.eye(S, dtype=robot_states.dtype, device=dev)], dim=-1)
            blocks_A.append(eye_s.expand(B, S, n))
            blocks_lb.append(robot_states.new_zeros((B, S)))
            blocks_ub.append(robot_states.new_full((B, S), BIG))

        return QPBatch(P=P, q=q, A=torch.cat(blocks_A, dim=1),
                       lb=torch.cat(blocks_lb, dim=-1), ub=torch.cat(blocks_ub, dim=-1))

    def control(self, robot_states: Tensor, self_idx: Tensor, desired_u: Tensor,
                warm: Optional[Tuple[Tensor, Tensor]] = None,
                lam2_eigvec=None) -> CBFControlResult:
        qp = self.assemble(robot_states, self_idx, desired_u, lam2_eigvec)
        x0, y0 = warm if warm is not None else (None, None)
        return _result(solve_batch(qp, self.solver, x0=x0, y0=y0))

    def control_all(self, robot_states: Tensor, desired_us: Tensor) -> CBFControlResult:
        """All robots of every team in one solve: robot_states [..., R, 6],
        desired_us [..., R, 3]; the result's leaves are [..., R, ...]. The
        team eigendecomposition runs ONCE per team here, not once per robot
        (the reference recomputes it per robot call,
        ConnectivityControl.cpp:69: a per-team quantity)."""
        R = self.R
        lead = robot_states.shape[:-2]
        teams = robot_states.reshape(-1, R, 6)
        T = teams.shape[0]
        lam2, eigvec = self.cbf.lambda2(teams[..., :2])
        per_robot = lambda v: v[:, None].expand(T, R, *v.shape[1:]).reshape(T * R, *v.shape[1:])
        self_idx = torch.arange(R, device=teams.device).repeat(T)
        res = self.control(per_robot(teams), self_idx, desired_us.reshape(T * R, 3),
                           lam2_eigvec=(per_robot(lam2), per_robot(eigvec)))
        return CBFControlResult(*(a.reshape(*lead, R, *a.shape[1:]) for a in res))
