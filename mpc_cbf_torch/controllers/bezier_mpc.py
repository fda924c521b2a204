"""Piecewise-Bézier MPC operator (static precompute + batched QP pieces)
and the CBF-free ``BezierMPC`` controller (counterpart of
``mpc_cbf_tpu/controllers/bezier_mpc.py``).

Reference parity:
- operators:  ``mpc/src/optimization/PiecewiseBezierMPCQPOperations.cpp``
  (ctor :9-38, evalSamplingBasisMatrix :41-60, positionErrorPenaltyCost
  :62-91, controlEffortPenaltyCost :93-108)
- generator:  ``mpc/src/optimization/PiecewiseBezierMPCQPGenerator.cpp``
  (addEvalConstraint :167-180, addContinuityConstraint :182-229,
  addEvalBoundConstraints :148-165, addHyperplaneConstraintForPiece :229-…)
- controller: ``mpc/src/controller/BezierMPC.cpp:36-98``

Every matrix the reference assembles per solve with Eigen is either static
(precomputed once with float64 numpy, then held as a tensor on the
operator's device in its dtype) or a batched contraction of the current
state (linear cost, Voronoi rows). The methods take batch-first tensors:
``[B, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mpc_cbf_torch.types import BIG, QPBatch, State
from mpc_cbf_torch.models.double_integrator import DoubleIntegrator
from mpc_cbf_torch.ops.bernstein import PiecewiseBezier
from mpc_cbf_torch.ops.geometry import voronoi_hyperplane, shift_hyperplane_for_box
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch


@dataclasses.dataclass(frozen=True)
class BezierParams:
    """bezier_params of base_config.json:66-71."""
    num_pieces: int = 3
    num_control_points: int = 4
    piece_max_parameter: float = 0.5
    continuity_degree: int = 3  # bezier_continuity_upto_degree


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """mpc_params + physical_limits of base_config.json."""
    h: float = 0.1
    Ts: float = 0.01
    k_hor: int = 16
    w_pos_err: float = 10.0
    w_u_eff: float = 10.0
    spd_f: int = 8
    v_min: Tuple[float, ...] = (-2.0, -2.0, -2.6179938779914944)
    v_max: Tuple[float, ...] = (2.0, 2.0, 2.6179938779914944)
    a_min: Tuple[float, ...] = (-5.0, -5.0, -3.141592653589793)
    a_max: Tuple[float, ...] = (5.0, 5.0, 3.141592653589793)

    def validate(self, bezier: BezierParams):
        """Invariants of common/parsing.hpp:49-76 + config.md."""
        if self.Ts > self.h:
            raise ValueError("Ts must be <= h")
        if abs(self.h / self.Ts - round(self.h / self.Ts)) > 1e-9:
            raise ValueError("h must be an integer multiple of Ts")
        if self.spd_f > self.k_hor:
            raise ValueError("spd_f must be <= k_hor")
        horizon_span = (self.k_hor - 1) * self.h
        curve_span = bezier.num_pieces * bezier.piece_max_parameter
        if horizon_span > curve_span + 1e-9:
            raise ValueError(
                f"k_hor={self.k_hor} samples span {horizon_span}s beyond the "
                f"curve duration {curve_span}s")


class BezierMPCOperator:
    """Static operators for one (bezier_params, mpc_params, dim) config.

    The numpy statics (float64) carry the JAX package's names; the tensors
    used per call live on ``device`` in ``dtype``.
    """

    def __init__(self, bezier: BezierParams, mpc: MPCParams, dim: int = 3, *,
                 device: torch.device | str, dtype: torch.dtype):
        mpc.validate(bezier)
        self.bezier, self.mpc, self.dim = bezier, mpc, dim
        # resolved ('cuda' -> 'cuda:0') so device checks compare like with like
        self.device, self.dtype = torch.empty(0, device=device).device, dtype
        self.pw = PiecewiseBezier(
            bezier.num_pieces, bezier.num_control_points, bezier.piece_max_parameter, dim
        )
        self.n_dec = self.pw.num_decision_variables
        model = DoubleIntegrator(dim=dim, ts=mpc.h)
        K = mpc.k_hor

        # h_samples = [0, h, ..., (K-1) h] (PiecewiseBezierMPCQPOperations.cpp:31-34)
        self.h_samples = np.linspace(0.0, (K - 1) * mpc.h, K)
        # U_basis: control points -> sampled accelerations  [dim*K, n_dec]
        self.U_basis = self.pw.eval_matrix(self.h_samples, 2)
        # position/velocity sampling of the curve itself
        self.pos_basis = self.pw.eval_matrix(self.h_samples, 0)
        self.vel_basis = self.pw.eval_matrix(self.h_samples, 1)

        A0_pos, _ = model.get_A0(K)
        L_pos, _ = model.get_lambda(K)
        self.A0_pos, self.Lambda_pos = A0_pos, L_pos

        # Q_pe: weight only the last spd_f steps
        # (positionErrorPenaltyCost, PiecewiseBezierMPCQPOperations.cpp:62-78)
        qdiag = np.zeros(dim * K)
        qdiag[dim * (K - mpc.spd_f):] = mpc.w_pos_err
        self.Qpe_diag = qdiag
        self.Phi = L_pos @ self.U_basis  # [dim*K, n_dec]

        # quadratic cost (z'Qz convention -> P = 2Q):
        #   pos-err quad: Phi' Qpe Phi
        #   effort: sum_{d=1..continuity} w_u_eff * Gram_d
        #   (BezierMPC.cpp:40-47 / FovBezierIMPCCBF.cpp:89-98)
        Q = self.Phi.T @ (qdiag[:, None] * self.Phi)
        for d in range(1, bezier.continuity_degree + 1):
            Q = Q + mpc.w_u_eff * self.pw.effort_gram(d)
        self.P_static = 2.0 * Q

        # equality rows: init pos/vel eval at t=0 (targets dynamic) +
        # continuity rows d=0..continuity-1 (targets 0)
        self.init_pos_rows = self.pw.piece_eval_row(0, 0.0, 0)  # [dim, n]
        self.init_vel_rows = self.pw.piece_eval_row(0, 0.0, 1)
        self.cont_rows = self.pw.continuity_rows(bezier.continuity_degree)

        # derivative bound rows at h_samples (addEvalBoundConstraints for
        # derivative degrees 2 then 1, FovBezierIMPCCBF.cpp:204-205)
        self.acc_rows = self.U_basis
        self.vel_rows = self.vel_basis

        # control-point selectors of piece 0 for hyperplane rows
        self.cp_rows_piece0 = self.pw.control_point_rows_for_piece(0)  # [P, dim, n]

        # curve sampling at the Ts grid for the sim step
        # (ts_samples, FovBezierIMPCCBF.cpp:36-40)
        u_interp = int(round(mpc.h / mpc.Ts))
        self.ts_samples = np.linspace(0.0, mpc.h - mpc.Ts, u_interp)

        # device copies of the statics used per call
        t = self.tensor
        self._A0 = t(self.A0_pos)
        self._Phi = t(self.Phi)
        self._w = t(self.Qpe_diag)
        self._cp0 = t(self.cp_rows_piece0)
        self._bound_A = t(np.concatenate([self.acc_rows, self.vel_rows]))
        self._bound_lb = t(np.concatenate([np.tile(mpc.a_min, K), np.tile(mpc.v_min, K)]))
        self._bound_ub = t(np.concatenate([np.tile(mpc.a_max, K), np.tile(mpc.v_max, K)]))
        self._P = t(self.P_static)
        self._eq_A = t(np.concatenate([self.init_pos_rows, self.init_vel_rows, self.cont_rows]))
        self._U_steps = t(self.U_basis.reshape(K, dim, self.n_dec))
        self._eval_cache = {}

    def tensor(self, a) -> torch.Tensor:
        """A constant on this operator's device in its dtype."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # ----- cost -------------------------------------------------------------
    def linear_cost(self, x0: torch.Tensor, ref_positions: torch.Tensor) -> torch.Tensor:
        """q [B, n_dec] from current states x0 [B, 2*dim] + reference
        positions [B, dim*K] (PiecewiseBezierMPCQPOperations.cpp:81-88).
        P is static."""
        drift = x0 @ self._A0.T  # [B, dim*K]
        return 2.0 * ((drift - ref_positions) * self._w) @ self._Phi

    # ----- constraint blocks ------------------------------------------------
    def equality_rows(self, current: State):
        """(A [m, n_dec], lb [B, m], ub [B, m]) for init-state + continuity
        equalities; the coefficients are shared by all lanes."""
        B = current.pos.shape[0]
        target = torch.cat([current.pos, current.vel,
                            current.pos.new_zeros((B, self.cont_rows.shape[0]))], dim=-1)
        return self._eq_A, target, target

    def bound_rows(self):
        """(A, lb, ub) for sampled accel + vel bounds (shared by all lanes)."""
        return self._bound_A, self._bound_lb, self._bound_ub

    def voronoi_rows(self, current_pos: torch.Tensor, other_positions: torch.Tensor,
                     other_mask: torch.Tensor, box_half_extents: torch.Tensor,
                     epsilon: float = 1e-8):
        """Per-neighbor separating-hyperplane rows on piece-0 control points
        (FovBezierIMPCCBF.cpp:116-134; hyperplaneConstraintAll,
        BezierQPOperations.cpp:269-290). Yaw dimension zeroed as in the
        reference (current_xy(DIM-1)=0).

        current_pos [B, dim], other_positions [B, N, dim], other_mask [B, N];
        returns ([B, N*P, n_dec], lb [B, N*P], ub [B, N*P]).
        """
        self_xy = current_pos.clone()
        self_xy[..., -1] = 0.0
        o_xy = other_positions.clone()
        o_xy[..., -1] = 0.0
        normal, offset = voronoi_hyperplane(self_xy[:, None, :], o_xy)   # [B,N,dim],[B,N]
        offset = shift_hyperplane_for_box(normal, offset, box_half_extents)
        # row per control point: normal . cp <= -offset - eps
        rows = torch.einsum("bnd,pdj->bnpj", normal, self._cp0)        # [B,N,P,n]
        active = other_mask[:, :, None]
        rows = torch.where(active[..., None], rows, torch.zeros_like(rows))
        ub = (-offset - epsilon)[:, :, None].expand(rows.shape[:3])
        ub = torch.where(active, ub, torch.full_like(ub, BIG))
        B, N, P = rows.shape[:3]
        return (
            rows.reshape(B, N * P, self.n_dec),
            torch.full((B, N * P), -BIG, dtype=rows.dtype, device=rows.device),
            ub.reshape(B, N * P),
        )

    def cbf_row_from_state_row(self, a: torch.Tensor, b: torch.Tensor, k):
        """Lift instantaneous CBF rows (a . u_k + b >= 0) onto control
        points via the acceleration sampling basis:
        -(a . U_basis[k-block]) z <= b (FovMPCCBFQPOperations.cpp:28-41).

        k is the horizon step (an int, or an integer tensor [...] with one
        step per row), a [..., dim], b [...].
        """
        return -torch.einsum("...d,...dj->...j", a, self._U_steps[k]), b

    # ----- curve evaluation -------------------------------------------------
    def eval_matrix(self, ts: Sequence[float], derivative: int = 0) -> torch.Tensor:
        """[len(ts)*dim, n_dec] sampling operator as a tensor, made once per
        (ts, derivative)."""
        key = (tuple(float(t) for t in ts), derivative)
        if key not in self._eval_cache:
            self._eval_cache[key] = self.tensor(self.pw.eval_matrix(list(key[0]), derivative))
        return self._eval_cache[key]

    def eval_solution(self, z: torch.Tensor, ts: Sequence[float],
                      derivative: int = 0) -> torch.Tensor:
        """The curve's derivative at times ts: z [..., n_dec] -> [..., len(ts), dim]."""
        out = z @ self.eval_matrix(ts, derivative).T
        return out.reshape(*out.shape[:-1], len(ts), self.dim)


class BezierMPC:
    """Goal-reaching Bézier MPC without CBF (BezierMPC.cpp:36-98), over a
    batch of lanes."""

    def __init__(self, op: BezierMPCOperator, max_neighbors: int = 0,
                 box_half_extents=None, solver: ADMMConfig = ADMMConfig(iters=150)):
        self.op = op
        self.N = max_neighbors
        self.box = op.tensor(
            box_half_extents if box_half_extents is not None else np.zeros(op.dim)
        )
        self.solver = solver
        self.m = (
            2 * op.dim  # init
            + op.cont_rows.shape[0]
            + 2 * op.dim * op.mpc.k_hor  # acc+vel bounds
            + max_neighbors * op.bezier.num_control_points
        )

    def assemble(self, current: State, ref_positions: torch.Tensor,
                 other_positions: Optional[torch.Tensor] = None,
                 other_mask: Optional[torch.Tensor] = None) -> QPBatch:
        """current [B, dim] State, ref_positions [B, dim*K], other_positions
        [B, N, dim], other_mask [B, N]. P [n, n] is shared by the lanes."""
        op = self.op
        B = ref_positions.shape[0]
        q = op.linear_cost(current.stacked, ref_positions)

        A_eq, lb_eq, ub_eq = op.equality_rows(current)
        A_bd, lb_bd, ub_bd = op.bound_rows()
        A = [A_eq.expand(B, -1, -1), A_bd.expand(B, -1, -1)]
        lb = [lb_eq, lb_bd.expand(B, -1)]
        ub = [ub_eq, ub_bd.expand(B, -1)]
        if self.N:
            A_v, lb_v, ub_v = op.voronoi_rows(current.pos, other_positions, other_mask, self.box)
            A.append(A_v)
            lb.append(lb_v)
            ub.append(ub_v)
        return QPBatch(P=op._P, q=q, A=torch.cat(A, dim=1), lb=torch.cat(lb, dim=-1),
                       ub=torch.cat(ub, dim=-1))

    def plan(self, current: State, ref_positions: torch.Tensor,
             other_positions: Optional[torch.Tensor] = None,
             other_mask: Optional[torch.Tensor] = None,
             warm: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None):
        """Solve one MPC step for every lane; returns (coeffs [B, n_dec],
        solution)."""
        qp = self.assemble(current, ref_positions, other_positions, other_mask)
        x0, y0 = warm if warm is not None else (None, None)
        sol = solve_batch(qp, self.solver, x0=x0, y0=y0)
        return sol.z, sol
