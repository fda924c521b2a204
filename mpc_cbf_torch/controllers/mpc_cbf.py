"""Iterative MPC-CBF controllers, batched (counterpart of
``mpc_cbf_tpu/controllers/mpc_cbf.py``).

Reference parity:
- FoV variant:          ``mpc_cbf/src/controller/FovBezierIMPCCBF.cpp:47-223``
- Connectivity variant: ``mpc_cbf/src/controller/ConnectivityIMPCCBF.cpp:47-215``
- constraint lifting:   ``mpc_cbf/src/optimization/FovMPCCBFQPOperations.cpp``
  (instantaneous CBF row applied at horizon step k through the acceleration
  sampling basis U_basis: A_row = -(a . U_basis[k]) with ub = b)
- slack plumbing:       ``mpc_cbf/src/optimization/MPCCBFQPGeneratorBase.cpp``

Iteration scheme (both variants):
  iter 0:   CBF rows evaluated at the *current* state, applied at step 0.
  iter > 0: previous iterate's curve sampled at h_samples[0..cbf_horizon)
            -> predicted states -> CBF rows applied at their step k.

Fixed-shape design: the CBF block always has
``num_families * cbf_horizon * max_neighbors`` rows; inactive rows are
masked. Where the JAX package writes per-agent functions and vmaps them,
the assembly here takes batch-first tensors ([B, ...]) directly; only the
autodiff CBF rows go through ``torch.func.vmap``.

Slack weights are distance-ranked (nearest neighbor keeps the highest
violation price): w_i = slack_cost * decay^rank(i)
(ConnectivityIMPCCBF.cpp:74-101).

Two routes run the same assembly: ``optimize`` solves each lane's dense
QP with the batched ADMM (``ops/qp/admm.py``), and ``StructuredIMPC`` runs
the batch through the structure-exploiting solvers (the Woodbury ADMM,
optionally with the f64 active-set polish, the f32/f64 Mehrotra IPM, the
f32 -> f64 hybrid IPM).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_cbf_torch.types import BIG, QPBatch, State
from mpc_cbf_torch.ops.cbf import FovCBF, ConnectivityCBF
from mpc_cbf_torch.ops.geometry import distance_to_ellipse
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch
from mpc_cbf_torch.ops.qp.structured import StructuredConfig, StructuredQPOperator
from mpc_cbf_torch.ops.qp.ipm import HybridIPM, HybridIPMConfig, IPMConfig, StructuredIPM
from mpc_cbf_torch.controllers.bezier_mpc import BezierMPCOperator
from mpc_cbf_torch.utils import profiling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IMPCParams:
    """cbf_params of base_config.json:55-63 (IMPCParams in the reference)."""
    cbf_horizon: int = 2
    impc_iter: int = 2
    slack_mode: bool = False
    slack_cost: float = 50000.0
    slack_decay_rate: float = 0.1


# CBF bound magnitudes are capped here: the alpha compositions (fifth power
# twice for FoV) reach 1e28 for distant neighbors, which float32 cannot carry
# through the solver. No achievable |a . U z| exceeds ~1e4, so any bound
# beyond the cap is equivalent to +inf (and a bound below -cap is still an
# infeasible row that trips the failure path).
CBF_BOUND_CAP = 1.0e6


class IMPCResult(NamedTuple):
    coeffs: Tensor         # [B, n_dec] control points of the curve to fly:
                           # the last USABLE iterate, else the final finite
                           # iterate (mpc_cbf_tpu IMPCResult has the details)
    success: Tensor        # [B] bool: at least one iterate was usable
    flyable: Tensor        # [B] bool: coeffs hold SOME finite curve to fly
    all_converged: Tensor  # [B] bool: every iteration strictly converged
    pri_res: Tensor        # [B] worst primal residual across iterations
    iterates: Tensor       # [impc_iter, B, n_dec] per-iteration solutions
    # final ADMM duals (unscaled row coords) — feed back as warm_duals to
    # the next replan step; None on the IPM family, which keeps no duals
    ys: Optional[Tensor] = None
    yd: Optional[Tensor] = None
    # [B] bool: the flown curve carries the <1e-3 deviation certificate —
    # the last solve's `converged` on certifying solvers (the f64 IPM and
    # the hybrid), all False on the f32 ADMM and the f32 IPM
    certified: Optional[Tensor] = None


def _rank_weights(distances: Tensor, w_init: float, decay: float) -> Tensor:
    """w[..., i] = w_init * decay^rank(i), nearest first, over the last axis.

    The sort is stable (as ``jnp.argsort`` is): tied distances — every
    masked neighbor sits at +inf — rank by index."""
    order = torch.argsort(distances, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device)
                   .expand_as(order))
    return w_init * decay ** ranks.to(distances.dtype)


class _IMPCCBFBase:
    """Shared fixed-shape assembly for both IMPC-CBF variants."""

    #: an iterate is flyable even when the solver missed its convergence
    #: bars, as long as every constraint is violated by at most this much
    #: (quantified in mpc_cbf_tpu/controllers/mpc_cbf.py and pinned by
    #: tests/test_usable_eps.py)
    USABLE_PRI_EPS: float = 0.05

    #: number of CBF constraint families per neighbor (4 for FoV, 1 for conn)
    num_families: int = 1
    #: continuity degrees: Fov uses d in [0, cont), connectivity [0, cont]
    continuity_inclusive: bool = False
    #: extra dynamic rows beyond the CBF block (e.g. Voronoi); set by variants
    m_extra: int = 0

    def __init__(self, op: BezierMPCOperator, impc: IMPCParams, max_neighbors: int,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        self.op = op
        self.impc = impc
        self.N = max_neighbors
        self.S = max_neighbors if impc.slack_mode else 0
        #: the dense route's solver (``optimize``); a sim's structured route
        #: takes its iteration budget from it when given no config of its own
        self.solver = solver
        self.n = op.n_dec + self.S

        upto = op.bezier.continuity_degree + (1 if self.continuity_inclusive else 0)
        self._cont_rows = op.pw.continuity_rows(upto)
        self.m_cbf = self.num_families * impc.cbf_horizon * max_neighbors

        H, F, N = impc.cbf_horizon, self.num_families, max_neighbors
        # U_basis row block of each CBF horizon step: [H, dim, n_dec]
        self._U_steps = op._U_steps[:H]
        # reachable |u| under asymmetric bounds is max(|a_min|, |a_max|)
        self._a_reach = float(max(np.max(np.abs(np.asarray(op.mpc.a_max))),
                                  np.max(np.abs(np.asarray(op.mpc.a_min)))))
        # slack column of each CBF row: rows are laid out [H, N, F]
        slack_idx = np.broadcast_to(np.arange(N)[None, :, None], (H, N, F))
        self._slack_idx = torch.as_tensor(np.ascontiguousarray(slack_idx).reshape(self.m_cbf),
                                          device=op.device)
        # the dense route's shared blocks, in the order assemble stacks them
        self._A_eq = op.tensor(np.concatenate([op.init_pos_rows, op.init_vel_rows,
                                               self._cont_rows]))
        P = np.zeros((self.n, self.n))
        P[: op.n_dec, : op.n_dec] = op.P_static
        self._P = op.tensor(P)
        self._slack_rows = op.tensor(np.concatenate(
            [np.zeros((self.S, op.n_dec)), np.eye(self.S)], axis=1))
        hs = list(np.asarray(op.h_samples[:H]))
        self._pos_E = op.tensor(op.pw.eval_matrix(hs, 0))
        self._vel_E = op.tensor(op.pw.eval_matrix(hs, 1))

    # -- variant hooks -------------------------------------------------------
    def _cbf_rows_at(self, x: Tensor, neighbor_blob: Tensor):
        """Return (A [F,3], b [F]) instantaneous CBF rows for one neighbor at
        one state, F = num_families (vmapped by _cbf_block)."""
        raise NotImplementedError

    def _neighbor_distance(self, current_pos: Tensor, neighbor_blob: Tensor) -> Tensor:
        """[B, N] distances from current_pos [B, dim] to each neighbor."""
        raise NotImplementedError

    def _extra_rows(self, current: State, neighbor_blob: Tensor, neighbor_mask: Tensor,
                    pred_states: Tensor, active_k: Tensor):
        """Optional variant-specific rows (e.g. Voronoi hyperplanes); returns
        a list of (A [B, m, n], lb [B, m], ub [B, m]) or None."""
        return None

    # -- assembly ------------------------------------------------------------
    def _cbf_block(self, pred_states: Tensor, neighbor_blob: Tensor,
                   neighbor_mask: Tensor, active_k: Tensor):
        """All CBF rows: pred_states [B, H, 6] (H = cbf_horizon), applied at
        step k; active_k [H] bool masks which horizon steps are in use.

        Returns (A [B, m_cbf, n_dec], ub [B, m_cbf], slack_idx [m_cbf],
        mask [B, m_cbf]).
        """
        op = self.op
        H, F, N = self.impc.cbf_horizon, self.num_families, self.N
        B, sd, nb = pred_states.shape[0], pred_states.shape[-1], neighbor_blob.shape[-1]

        x = pred_states[:, :, None, :].expand(B, H, N, sd).reshape(-1, sd)
        nbr = neighbor_blob[:, None, :, :].expand(B, H, N, nb).reshape(-1, nb)
        A_f, b_all = vmap(self._cbf_rows_at)(x, nbr)       # [BHN, F, 3], [BHN, F]
        A_f = A_f.reshape(B, H, N, F, op.dim)
        b_all = b_all.reshape(B, H, N, F)
        A_all = -torch.einsum("bhnfd,hdj->bhnfj", A_f, self._U_steps)
        a_l1 = torch.sum(torch.abs(A_f), dim=-1)

        mask = (active_k[None, :, None, None] & neighbor_mask[:, None, :, None]) \
            .expand(B, H, N, F)
        # Prune provably-inactive rows: the accel bound rows already enforce
        # |u_k| <= a_reach, so any b beyond ||a||_1 * a_reach can never
        # bind, and leaving such rows "active" with huge finite bounds
        # destroys the f32 ADMM row scaling (mpc_cbf_tpu has the full note).
        a_reach = self._a_reach
        mask = mask & (b_all <= a_l1 * a_reach)
        A_all = torch.where(mask[..., None], A_all, torch.zeros_like(A_all))
        # Symmetric lower cap at the same reachability threshold (x2
        # margin): it changes only the slack's value, never the optimal
        # control, and keeps the slack columns in f32 range.
        b_all = torch.maximum(b_all, -2.0 * a_l1 * a_reach)
        b_all = torch.clamp(b_all, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        ub_all = torch.where(mask, b_all, torch.full_like(b_all, BIG))
        return (
            A_all.reshape(B, self.m_cbf, op.n_dec),
            ub_all.reshape(B, self.m_cbf),
            self._slack_idx,
            mask.reshape(B, self.m_cbf),
        )

    def _widen(self, A: Tensor, slack_idx: Optional[Tensor] = None,
               mask: Optional[Tensor] = None) -> Tensor:
        """Append slack columns to A [B, m, n_dec] (zero, or -1 at
        slack_idx where mask)."""
        if self.S == 0:
            return A
        if slack_idx is None:
            return torch.cat([A, A.new_zeros((*A.shape[:-1], self.S))], dim=-1)
        cols = -torch.nn.functional.one_hot(slack_idx, self.S).to(A.dtype)   # [m, S]
        cols = cols.expand(*A.shape[:-1], self.S)
        if mask is not None:
            cols = torch.where(mask[..., None], cols, torch.zeros_like(cols))
        return torch.cat([A, cols], dim=-1)

    # -- dense assembly ------------------------------------------------------
    def _static_blocks(self, current: State):
        """((A_eq, lb_eq, ub_eq), (A_bd, lb_bd, ub_bd)): the init-state and
        continuity equalities and the sampled bounds, coefficients [m, n_dec]
        shared by the lanes, targets [B, m]."""
        B = current.pos.shape[0]
        t_eq = torch.cat([current.pos, current.vel,
                          current.pos.new_zeros((B, self._cont_rows.shape[0]))], -1)
        A_bd, lb_bd, ub_bd = self.op.bound_rows()
        return (self._A_eq, t_eq, t_eq), (A_bd, lb_bd.expand(B, -1), ub_bd.expand(B, -1))

    def assemble(self, current: State, ref_positions: Tensor, neighbor_blob: Tensor,
                 neighbor_mask: Tensor, pred_states: Tensor, active_k: Tensor) -> QPBatch:
        """Each lane's dense QP: current [B, dim] State, ref [B, dim*K],
        neighbor_blob [B, N, ...], neighbor_mask [B, N], pred_states
        [B, H, 2*dim], active_k [H]. Rows: equalities, sampled bounds, CBF
        rows, the variant's extra rows, slack nonnegativity. P [n, n] is
        shared by the lanes."""
        B = ref_positions.shape[0]
        q = self.cost_vector(current, ref_positions, neighbor_blob, neighbor_mask)
        (A_eq, lb_eq, ub_eq), (A_bd, lb_bd, ub_bd) = self._static_blocks(current)
        A_d, lb_d, ub_d = self.dynamic_rows(current, neighbor_blob, neighbor_mask,
                                            pred_states, active_k)
        A = [self._widen(A_eq).expand(B, -1, -1), self._widen(A_bd).expand(B, -1, -1), A_d]
        lb, ub = [lb_eq, lb_bd, lb_d], [ub_eq, ub_bd, ub_d]
        if self.S:
            A.append(self._slack_rows.expand(B, -1, -1))
            lb.append(q.new_zeros((B, self.S)))
            ub.append(q.new_full((B, self.S), BIG))
        return QPBatch(P=self._P, q=q, A=torch.cat(A, dim=1), lb=torch.cat(lb, dim=-1),
                       ub=torch.cat(ub, dim=-1))

    def predicted_states(self, coeffs: Tensor) -> Tensor:
        """[B, H, 2*dim]: an iterate's curve sampled at the first
        cbf_horizon replan times."""
        B, H, dim = coeffs.shape[0], self.impc.cbf_horizon, self.op.dim
        pos = (coeffs @ self._pos_E.T).reshape(B, H, dim)
        vel = (coeffs @ self._vel_E.T).reshape(B, H, dim)
        return torch.cat([pos, vel], dim=-1)

    # -- the IMPC loop over the dense solver ---------------------------------
    def optimize(self, current: State, ref_positions: Tensor, neighbor_blob: Tensor,
                 neighbor_mask: Tensor, warm: Optional[Tensor] = None) -> IMPCResult:
        """Run impc_iter assembly+solve rounds on every lane's dense QP
        (FovBezierIMPCCBF.cpp:84-223): current [B, dim] State, ref
        [B, dim*K], neighbor_blob [B, N, ...], neighbor_mask [B, N].

        warm: optional [B, n] primal warm start (e.g. previous MPC step).
        """
        op, H = self.op, self.impc.cbf_horizon
        B = ref_positions.shape[0]
        dev = current.pos.device

        # iteration 0: only step 0 active, pred state = current state
        x_now = current.stacked
        pred = x_now[:, None, :].expand(B, H, x_now.shape[-1])
        active = torch.arange(H, device=dev) == 0

        x0, y0 = warm, None
        coeffs = x_now.new_zeros((B, op.n_dec))
        # the curve actually flown: the LAST USABLE iterate (the reference
        # appends a curve per successful solve and the caller flies
        # trajs.back(), MPCCBFFormationControl_example.cpp:160-163)
        best = x_now.new_zeros((B, op.n_dec))
        any_ok = torch.zeros(B, dtype=torch.bool, device=dev)
        all_ok = torch.ones(B, dtype=torch.bool, device=dev)
        worst = x_now.new_zeros(B)
        iterates = []

        for it in range(self.impc.impc_iter):
            if it > 0:
                pred = self.predicted_states(coeffs)
                active = torch.ones(H, dtype=torch.bool, device=dev)
            qp = self.assemble(current, ref_positions, neighbor_blob, neighbor_mask,
                               pred, active)
            sol = solve_batch(qp, self.solver, x0=x0, y0=y0)
            coeffs = sol.z[:, : op.n_dec]
            x0, y0 = sol.z, sol.y
            finite = torch.all(torch.isfinite(sol.z), dim=-1)
            usable = sol.converged | ((sol.pri_res <= self.USABLE_PRI_EPS) & finite)
            best = torch.where(usable[:, None], coeffs, best)
            any_ok = any_ok | usable
            all_ok = all_ok & sol.converged
            worst = torch.maximum(worst, sol.pri_res)
            iterates.append(coeffs)

        last_finite = torch.all(torch.isfinite(coeffs), dim=-1)
        fly = torch.where(any_ok[:, None], best,
                          torch.where(last_finite[:, None], coeffs, best))
        return IMPCResult(coeffs=fly, success=any_ok,
                          flyable=any_ok | last_finite, all_converged=all_ok,
                          pri_res=worst, iterates=torch.stack(iterates, dim=0))

    # -- structured assembly -------------------------------------------------
    def static_parts(self):
        """(P [n,n], A_s [m_s,n], eq_mask [m_s]) — the blocks shared by every
        agent in a batch (coefficients only; targets are per-agent).

        Shared rows: init pos/vel eval (eq), continuity (eq), sampled
        accel/vel bounds, slack nonnegativity.
        """
        op, S, n = self.op, self.S, self.n
        P = np.zeros((n, n))
        P[: op.n_dec, : op.n_dec] = op.P_static
        rows = [
            np.concatenate([op.init_pos_rows, op.init_vel_rows, self._cont_rows]),
            np.concatenate([op.acc_rows, op.vel_rows]),
        ]
        eq_m = [np.ones(rows[0].shape[0], bool), np.zeros(rows[1].shape[0], bool)]
        A_s = np.concatenate(rows)
        A_s = np.concatenate([A_s, np.zeros((A_s.shape[0], S))], axis=1)
        if S:
            slack_rows = np.concatenate([np.zeros((S, op.n_dec)), np.eye(S)], axis=1)
            A_s = np.concatenate([A_s, slack_rows])
            eq_m.append(np.zeros(S, bool))
        return P, A_s, np.concatenate(eq_m)

    def shared_bounds(self, current: State):
        """(lb_s, ub_s) [B, m_s]: targets of the shared rows per agent."""
        S = self.S
        B = current.pos.shape[0]
        zeros = current.pos.new_zeros
        t_eq = torch.cat([current.pos, current.vel, zeros((B, self._cont_rows.shape[0]))], -1)
        _, lb_bd, ub_bd = self.op.bound_rows()
        lb = torch.cat([t_eq, lb_bd.expand(B, -1)], -1)
        ub = torch.cat([t_eq, ub_bd.expand(B, -1)], -1)
        if S:
            lb = torch.cat([lb, zeros((B, S))], -1)
            ub = torch.cat([ub, current.pos.new_full((B, S), BIG)], -1)
        return lb, ub

    def dynamic_rows(self, current: State, neighbor_blob: Tensor, neighbor_mask: Tensor,
                     pred_states: Tensor, active_k: Tensor):
        """(A_d [B, m_d, n], lb_d, ub_d [B, m_d]): CBF rows (+ variant
        extras such as Voronoi), slack columns included."""
        A_cbf, ub_cbf, slack_idx, cbf_mask = self._cbf_block(
            pred_states, neighbor_blob, neighbor_mask, active_k
        )
        A = [self._widen(A_cbf, slack_idx, cbf_mask)]
        lb = [torch.full_like(ub_cbf, -BIG)]
        ub = [ub_cbf]
        for (Ae, lbe, ube) in self._extra_rows(current, neighbor_blob, neighbor_mask,
                                                 pred_states, active_k) or ():
            A.append(Ae)
            lb.append(lbe)
            ub.append(ube)
        return torch.cat(A, dim=1), torch.cat(lb, dim=-1), torch.cat(ub, dim=-1)

    def cost_vector(self, current: State, ref_positions: Tensor, neighbor_blob: Tensor,
                    neighbor_mask: Tensor) -> Tensor:
        """Linear cost q [B, n]: the Bézier-MPC tracking term on the curve
        columns, distance-ranked slack weights on the slack columns
        (the q of mpc_cbf_tpu StructuredIMPC.optimize_batch, :695-703)."""
        q_dec = self.op.linear_cost(current.stacked, ref_positions)
        if not self.S:
            return q_dec
        d = self._neighbor_distance(current.pos, neighbor_blob)
        d = torch.where(neighbor_mask, d, torch.full_like(d, float("inf")))
        w = _rank_weights(d, self.impc.slack_cost, self.impc.slack_decay_rate)
        return torch.cat([q_dec, w], dim=-1)

    @property
    def m_dynamic(self) -> int:
        return self.m_cbf + self.m_extra


class FovIMPCCBF(_IMPCCBFBase):
    """FoV variant: 4 families (safety, fov-lb, fov-rb, range) + Voronoi
    hyperplane rows on piece-0 control points.

    neighbor_blob per neighbor: [5] = [x, y, cov_xx, cov_xy, cov_yy]; the
    covariance feeds the slack distance ranking only.
    """

    num_families = 4
    continuity_inclusive = False

    def __init__(self, op: BezierMPCOperator, cbf: FovCBF, impc: IMPCParams,
                 max_neighbors: int, box_half_extents=None,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        super().__init__(op, impc, max_neighbors, solver)
        self.cbf = cbf
        self.m_extra = max_neighbors * op.bezier.num_control_points
        self.box = op.tensor(
            box_half_extents if box_half_extents is not None else np.zeros(op.dim)
        )

    @staticmethod
    def pack_neighbors(positions_xy: Tensor, covs: Tensor) -> Tensor:
        """[..., N, 2] + [..., N, 2, 2] -> blob [..., N, 5]."""
        return torch.cat(
            [positions_xy, covs[..., 0, 0:1], covs[..., 0, 1:2], covs[..., 1, 1:2]],
            dim=-1,
        )

    def _cbf_rows_at(self, x, nbr):
        t_xy = nbr[:2]
        a_s, b_s = self.cbf.safety_row(x, t_xy)
        a_l, b_l = self.cbf.lb_row(x, t_xy)
        a_r, b_r = self.cbf.rb_row(x, t_xy)
        a_g, b_g = self.cbf.range_row(x, t_xy)
        return torch.stack([a_s, a_l, a_r, a_g]), torch.stack([b_s, b_l, b_r, b_g])

    def _neighbor_distance(self, current_pos, neighbor_blob):
        cov = torch.stack([neighbor_blob[..., 2:4], neighbor_blob[..., 3:5]], dim=-2)
        return distance_to_ellipse(current_pos[:, None, :2], neighbor_blob[..., :2], cov)

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        B = neighbor_blob.shape[0]
        other_pos = torch.cat(
            [neighbor_blob[..., :2],
             neighbor_blob.new_zeros((B, self.N, self.op.dim - 2))], dim=-1
        )
        A_v, lb_v, ub_v = self.op.voronoi_rows(current.pos, other_pos, neighbor_mask,
                                               self.box)
        return [(self._widen(A_v), lb_v, ub_v)]


class BezierMPCCBF(FovIMPCCBF):
    """Non-iterative single-shot MPC-CBF (reference
    ``mpc_cbf/src/controller/BezierMPCCBF.cpp:32-85``): one QP with the
    3 FoV CBF families (safety, fov-lb, fov-rb; no range row, :61-67)
    evaluated at the *current* state and applied at horizon step 0. No
    slack variables, no Voronoi rows (the reference stores a collision
    shape but never adds hyperplane constraints in optimize()).

    neighbor_blob per neighbor: [2] = target x, y.
    """

    num_families = 3
    continuity_inclusive = False

    def __init__(self, op: BezierMPCOperator, cbf: FovCBF, max_neighbors: int,
                 solver: ADMMConfig = ADMMConfig(iters=150)):
        impc = IMPCParams(cbf_horizon=1, impc_iter=1, slack_mode=False)
        super().__init__(op, cbf, impc, max_neighbors, solver=solver)
        self.m_extra = 0  # no Voronoi rows in the single-shot variant

    def _cbf_rows_at(self, x, nbr):
        t_xy = nbr[:2]
        a_s, b_s = self.cbf.safety_row(x, t_xy)
        a_l, b_l = self.cbf.lb_row(x, t_xy)
        a_r, b_r = self.cbf.rb_row(x, t_xy)
        return torch.stack([a_s, a_l, a_r]), torch.stack([b_s, b_l, b_r])

    def _neighbor_distance(self, current_pos, neighbor_blob):
        return torch.linalg.vector_norm(
            neighbor_blob[..., :2] - current_pos[:, None, :2], dim=-1)

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        return None

    def derivative_control_inputs(self, coeffs: Tensor, derivative_degree: int) -> Tensor:
        """Sampled derivative at the Ts grid: U_basis(ts) @ coeffs
        (BezierMPCCBF.cpp:88-99). coeffs [..., n_dec] -> [..., len(ts_samples)*dim]."""
        return coeffs @ self.op.eval_matrix(self.op.ts_samples, derivative_degree).T


class ConnectivityIMPCCBF(_IMPCCBFBase):
    """Connectivity variant: pairwise safety CBF per neighbor
    (ConnectivityIMPCCBF.cpp:135-160; the lambda2/CLF block is present but
    disabled in the reference, see the enable_connectivity flag), no Voronoi
    rows, continuity degrees 0..continuity (inclusive, :127-132).

    neighbor_blob per neighbor: full state [6].
    """

    num_families = 1
    continuity_inclusive = True

    #: λ₂ > threshold -> single connectivity CBF row, else pairwise CLF
    #: rows (ConnectivityControl.cpp:70-72; the MPC-level block at
    #: ConnectivityIMPCCBF.cpp:144-157 is commented out in the reference;
    #: enable_connectivity=True turns on the constraint family it intended)
    LAMBDA2_THRESHOLD = 0.1

    def __init__(self, op: BezierMPCOperator, cbf: ConnectivityCBF, impc: IMPCParams,
                 max_neighbors: int, solver: ADMMConfig = ADMMConfig(iters=150),
                 enable_connectivity: bool = False):
        super().__init__(op, impc, max_neighbors, solver)
        self.cbf = cbf
        self.enable_connectivity = enable_connectivity
        if enable_connectivity:
            # per horizon step: 1 λ₂ row + N CLF rows (exactly one family
            # active per step, branch-masked: fixed shapes)
            self.m_extra = impc.cbf_horizon * (1 + max_neighbors)

    def _cbf_rows_at(self, x, nbr):
        a, b = self.cbf.safety_row(x, nbr)
        return a[None], b[None]

    def _neighbor_distance(self, current_pos, neighbor_blob):
        return torch.linalg.vector_norm(
            neighbor_blob[..., :2] - current_pos[:, None, :2], dim=-1)

    def _extra_rows(self, current, neighbor_blob, neighbor_mask,
                    pred_states, active_k):
        """λ₂-connectivity / CLF rows lifted through U_basis
        (ConnectivityMPCCBFQPOperations.cpp:45-87 + the pred variants
        :112-171): λ₂, eigvec and h = λ₂ − ε come from the CURRENT team;
        per horizon step k the ego row of the team is replaced by the
        predicted state, rows are applied at step k via U_basis, and ub is
        b (connectivity) / −b (CLF). Exactly one family is active per step
        by the λ₂ branch. No slack coupling (the reference passes a
        constant slack_value = 0). Row order per lane: the H λ₂ rows, then
        the H·N CLF rows.

        DELIBERATE sign deviation, as in the JAX package: the reference's
        clfConstraint (``ConnectivityMPCCBFQPOperations.cpp:75-87``) emits
        −(a·u) ≤ −b, but V̈ + β₁V̇ + β₂V ≤ 0 requires +(a·u) ≤ −b, the form
        its OWN live CBF-only generator uses
        (``ConnectivityQPGenerator.cpp:47-55``). The MPC-level block is
        commented out in the reference and never ran; mirroring its sign
        drives robots AWAY from d_desired. The correct sign is emitted.
        Masked neighbors are deflated out of λ₂ (see
        ConnectivityCBF.lambda2) and their eigvec entries set to the ego's
        so their gradient terms vanish identically."""
        if not self.enable_connectivity:
            return None
        cbf = self.cbf
        H, N = self.impc.cbf_horizon, self.N
        B, sd = pred_states.shape[0], pred_states.shape[-1]

        x_now = current.stacked
        team_now = torch.cat([x_now[:, None, :], neighbor_blob], dim=1)      # [B, N+1, 6]
        node_mask = torch.cat([torch.ones_like(neighbor_mask[:, :1]), neighbor_mask], dim=1)
        lam2, eigvec = cbf.lambda2(team_now[..., :2], node_mask)             # [B], [B, N+1]
        h_val = lam2 - cbf.epsilon
        use_conn = lam2 > self.LAMBDA2_THRESHOLD
        eigvec = torch.where(node_mask, eigvec, eigvec[:, :1])

        # the team at step k: the ego's predicted state, then the neighbors
        nbr_k = neighbor_blob[:, None, :, :].expand(B, H, N, sd)
        team_k = torch.cat([pred_states[:, :, None, :], nbr_k], dim=2)       # [B, H, N+1, 6]
        per_step = lambda v: v[:, None].expand(B, H, *v.shape[1:]).reshape(B * H, *v.shape[1:])
        a_c, b_c = vmap(lambda x, team, vec, h: cbf.conn_row(x, team, vec, h, 0))(
            pred_states.reshape(B * H, sd), team_k.reshape(B * H, N + 1, sd),
            per_step(eigvec), per_step(h_val))
        row_c = -torch.einsum("bhd,hdj->bhj", a_c.reshape(B, H, -1), self._U_steps)
        b_c = b_c.reshape(B, H)

        x_k = pred_states[:, :, None, :].expand(B, H, N, sd)
        a_v, b_v = vmap(cbf.clf_row)(x_k.reshape(-1, sd), nbr_k.reshape(-1, sd))
        A_clf = torch.einsum("bhnd,hdj->bhnj", a_v.reshape(B, H, N, -1), self._U_steps)
        b_clf = -b_v.reshape(B, H, N)

        conn_on = active_k[None, :] & use_conn[:, None]                      # [B, H]
        clf_on = (active_k[None, :] & ~use_conn[:, None])[:, :, None] & neighbor_mask[:, None, :]
        b_c = torch.clamp(b_c, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        b_clf = torch.clamp(b_clf, -CBF_BOUND_CAP, CBF_BOUND_CAP)
        A = torch.cat([
            torch.where(conn_on[..., None], row_c, torch.zeros_like(row_c)),
            torch.where(clf_on[..., None], A_clf, torch.zeros_like(A_clf)).reshape(B, H * N, -1),
        ], dim=1)
        ub = torch.cat([torch.where(conn_on, b_c, torch.full_like(b_c, BIG)),
                        torch.where(clf_on, b_clf, torch.full_like(b_clf, BIG)).reshape(B, H * N)],
                       dim=1)
        return [(self._widen(A), torch.full_like(ub, -BIG), ub)]


class StructuredIMPC:
    """Batched IMPC-CBF loop over the structure-exploiting solvers.

    Wraps a FovIMPCCBF / ConnectivityIMPCCBF and runs the whole agent (x
    scenario) batch through one solve per IMPC iteration: the structured
    ADMM (ops/qp/structured.py), the Mehrotra IPM or the hybrid IPM
    (ops/qp/ipm.py).
    """

    def __init__(self, ctrl: _IMPCCBFBase, cfg=None):
        """cfg: StructuredConfig (the f32 ADMM, with polish=True followed by
        the f64 active-set polish; None is the JAX package's default budget
        of 150 iterations), IPMConfig (the Mehrotra IPM:
        IPM_F32_ENTRY is the raw production profile, IPMConfig() the
        certified f64 one) or HybridIPMConfig (f32 entry + f64 tail;
        HYBRID_PROD is the shipping certified pipeline)."""
        self.ctrl = ctrl
        self.cfg = cfg if cfg is not None else StructuredConfig(iters=150)
        op = ctrl.op
        P, A_s, eq_mask = ctrl.static_parts()
        self.op_qp_tail = None
        if isinstance(self.cfg, HybridIPMConfig):
            hyb = HybridIPM(P, A_s, eq_mask, ctrl.m_dynamic, self.cfg, device=op.device)
            if self.cfg.entry_only_first:
                # iteration 0 runs only the f32 entry (it seeds iteration
                # 1's predicted-state rows); later iterations run the full
                # hybrid and carry the certificate of the flown curve
                self.op_qp, self.op_qp_tail = hyb.entry, hyb
            else:
                self.op_qp = hyb
        elif isinstance(self.cfg, IPMConfig):
            self.op_qp = StructuredIPM(P, A_s, eq_mask, ctrl.m_dynamic, self.cfg,
                                       device=op.device)
        elif isinstance(self.cfg, StructuredConfig):
            q_hint = ctrl.impc.slack_cost if ctrl.impc.slack_mode else 0.0
            # slack nonnegativity rows sit LAST in A_s (static_parts): the
            # stiff rho phase scales them with the dynamic rows, and the
            # polish keeps them pinnable. Each guard GROUP lists every row
            # touching slack j: its nonnegativity row plus its CBF rows
            # (layout [H, N, F] flattened, neighbour j owns rows
            # m_s + (h*N + j)*F + f), so the polish can keep >= 1 of them
            # pinned at all times.
            m_s = A_s.shape[0]
            guards, groups = (), ()
            if ctrl.S:
                H, F, N = ctrl.impc.cbf_horizon, ctrl.num_families, ctrl.N
                guards = tuple(range(m_s - ctrl.S, m_s))
                groups = tuple((m_s - ctrl.S + j,) + tuple(
                    m_s + (h * N + j) * F + f for h in range(H) for f in range(F))
                    for j in range(ctrl.S))

            def operator(cfg):
                return StructuredQPOperator(P, A_s, eq_mask, ctrl.m_dynamic, cfg,
                                            device=op.device, dtype=op.dtype,
                                            q_scale_hint=q_hint, polish_guard_rows=guards,
                                            polish_guard_groups=groups)

            self.op_qp = operator(self.cfg)
            # warm solves (IMPC iterations > 0) enter with carried duals and
            # a near-solution primal, so they can run a reduced budget
            if self.cfg.iters_tail is not None and self.cfg.iters_tail != self.cfg.iters:
                self.op_qp_tail = operator(
                    dataclasses.replace(self.cfg, iters=self.cfg.iters_tail))
        else:
            raise NotImplementedError(
                f"{type(self.cfg).__name__}: StructuredIMPC takes a StructuredConfig, "
                "an IPMConfig or a HybridIPMConfig")

    def optimize_batch(self, current: State, ref_positions: Tensor,
                       neighbor_blob: Tensor, neighbor_mask: Tensor,
                       warm: Optional[Tensor] = None,
                       warm_duals=None) -> IMPCResult:
        """Batched IMPC: current [B, ...] State, ref [B, dim*K],
        neighbor_blob [B, N, ...], neighbor_mask [B, N].

        warm: [B, n] primal warm start (e.g. the h-shifted previous
        curve). warm_duals: (ys [B, m_s], yd [B, m_d]) unscaled duals from
        the previous replan step's IMPCResult (ADMM only; the IPM family
        ignores both warm starts). coeffs come back in the dtype of
        ``current``, whatever the solver's compute dtype."""
        ctrl, op = self.ctrl, self.ctrl.op
        H = ctrl.impc.cbf_horizon
        B = ref_positions.shape[0]
        dev = current.pos.device
        dt = current.pos.dtype

        with profiling.span("assembly"):
            q = ctrl.cost_vector(current, ref_positions, neighbor_blob, neighbor_mask)
            lb_s, ub_s = ctrl.shared_bounds(current)

        x_now = current.stacked                                  # [B, 2*dim]
        pred0 = x_now[:, None, :].expand(B, H, x_now.shape[-1])
        active0 = torch.arange(H, device=dev) == 0

        coeffs = q.new_zeros((B, op.n_dec))
        best = q.new_zeros((B, op.n_dec))
        x0 = warm if warm is not None else q.new_zeros((B, ctrl.n))
        ys0, yd0 = warm_duals if warm_duals is not None else (None, None)
        any_ok = torch.zeros(B, dtype=torch.bool, device=dev)
        all_ok = torch.ones(B, dtype=torch.bool, device=dev)
        worst = q.new_zeros(B)
        iterates = []

        for it in range(ctrl.impc.impc_iter):
            with profiling.span("assembly"):
                if it == 0:
                    pred, active = pred0, active0
                else:
                    pred = ctrl.predicted_states(coeffs)
                    active = torch.ones(H, dtype=torch.bool, device=dev)
                A_d, lb_d, ub_d = ctrl.dynamic_rows(current, neighbor_blob, neighbor_mask,
                                                    pred, active)
            # iterations > 0 enter warm (previous iterate's primal AND
            # duals) and may run the reduced tail budget
            op_solve = self.op_qp if (it == 0 or self.op_qp_tail is None) \
                else self.op_qp_tail
            solve = op_solve.solve_polished if getattr(self.cfg, "polish", False) \
                else op_solve.solve
            with profiling.span("solve"):
                sol = solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0=x0, ys0=ys0, yd0=yd0)
            # back to the caller's dtype: an f64 solve must not leak into an
            # f32 caller (the round-off is far below the 1e-3 certificate)
            coeffs = sol.z[:, : op.n_dec].to(dt)
            x0 = sol.z
            ys0, yd0 = getattr(sol, "ys", None), getattr(sol, "yd", None)
            finite = torch.all(torch.isfinite(sol.z), dim=-1)
            usable = sol.converged | ((sol.pri_res <= ctrl.USABLE_PRI_EPS) & finite)
            best = torch.where(usable[:, None], coeffs, best)
            any_ok = any_ok | usable
            all_ok = all_ok & sol.converged
            worst = torch.maximum(worst, sol.pri_res.to(dt))
            iterates.append(coeffs)

        last_finite = torch.all(torch.isfinite(coeffs), dim=-1)
        fly = torch.where(any_ok[:, None], best,
                          torch.where(last_finite[:, None], coeffs, best))
        # certificate of the flown curve: the last iteration's solution is
        # the flown one whenever usable, and only a certifying solver's
        # converged flag means <1e-3 deviation
        if hasattr(sol, "certified"):          # ADMM family
            cert = sol.certified
        elif op_solve.certifies:
            cert = sol.converged               # f64 IPM / hybrid calibrated bars
        else:
            cert = torch.zeros(B, dtype=torch.bool, device=dev)
        return IMPCResult(coeffs=fly, success=any_ok,
                          flyable=any_ok | last_finite, all_converged=all_ok,
                          pri_res=worst, iterates=torch.stack(iterates, dim=0),
                          ys=ys0, yd=yd0, certified=cert)
