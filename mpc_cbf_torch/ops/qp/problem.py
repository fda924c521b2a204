"""Incremental QP builder, the qpcpp::Problem migration surface
(counterpart of ``mpc_cbf_tpu/ops/qp/problem.py``).

Reference parity: ``qpcpp/include/qpcpp/Problem.h``
(Variable :17-42, LinearConstraint :45-67, CostFunction :70-123,
Problem :131-196) and ``qpcpp/solvers/Solver.h:13-37`` (SolveStatus).

Users migrating from the reference build problems the same way
(``add_variable`` / ``add_linear_constraint`` / cost terms) and the
builder lowers to the dense tensor form (:class:`types.QPBatch`) solved
by the batched ADMM. For hot paths, assemble ``QPBatch`` tensors directly
(see controllers/); this class is the ergonomic one-off surface, and its
``reset_problem`` mirrors the reference's reuse pattern
(Problem::resetProblem keeps variables, drops constraints + cost).

The solve notion of success maps CPLEX's SolveStatus: OPTIMAL when the
ADMM converged, ERROR on non-finite, INFEASIBLE when the returned point
violates constraints badly (first-order solvers cannot *certify*
infeasibility; this is the practical mapping).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np
import torch

from mpc_cbf_torch.types import BIG, QPBatch
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch


class SolveStatus(enum.Enum):
    """qpcpp::SolveStatus (solvers/Solver.h:13-21)."""
    OPTIMAL = "optimal"
    FEASIBLE = "feasible"
    UNBOUNDED = "unbounded"
    INFEASIBLE = "infeasible"
    ERROR = "error"
    UNKNOWN = "unknown"
    INFEASIBLEORUNBOUNDED = "infeasible_or_unbounded"


class Variable:
    def __init__(self, problem: "Problem", index: int,
                 vmin: float = -BIG, vmax: float = BIG):
        self._problem = problem
        self.index = index
        self.min = float(vmin)
        self.max = float(vmax)
        self.solution_value: Optional[float] = None

    def set_min(self, v: float) -> None:
        self.min = float(v)

    def set_max(self, v: float) -> None:
        self.max = float(v)


class LinearConstraint:
    def __init__(self, problem: "Problem", cmin: float, cmax: float):
        self._problem = problem
        self.min = float(cmin)
        self.max = float(cmax)
        self._coeff: Dict[int, float] = {}

    def set_coefficient(self, var: Variable, coefficient: float) -> None:
        self._coeff[var.index] = float(coefficient)

    def get_coefficient(self, var: Variable) -> float:
        return self._coeff.get(var.index, 0.0)


class CostFunction:
    def __init__(self, problem: "Problem"):
        self._problem = problem
        self._quad: Dict[tuple, float] = {}
        self._lin: Dict[int, float] = {}
        self.constant = 0.0

    def add_quadratic_term(self, v1: Variable, v2: Variable,
                           coefficient: float) -> None:
        key = tuple(sorted((v1.index, v2.index)))
        self._quad[key] = self._quad.get(key, 0.0) + float(coefficient)

    def get_quadratic_coefficient(self, v1: Variable, v2: Variable) -> float:
        return self._quad.get(tuple(sorted((v1.index, v2.index))), 0.0)

    def add_linear_term(self, var: Variable, coefficient: float) -> None:
        self._lin[var.index] = self._lin.get(var.index, 0.0) + float(coefficient)

    def get_linear_coefficient(self, var: Variable) -> float:
        return self._lin.get(var.index, 0.0)

    def add_constant(self, c: float) -> None:
        self.constant += float(c)

    def set_zero(self) -> None:
        self._quad.clear()
        self._lin.clear()
        self.constant = 0.0


class Problem:
    """Incremental QP: minimize cost s.t. cmin <= A x <= cmax and
    variable bounds (Problem.h:131-196). ``device`` is where ``solve``
    runs and where ``to_qp_batch`` puts its tensors."""

    def __init__(self, *, device: torch.device | str):
        self.device = torch.device(device)
        self._vars: List[Variable] = []
        self._constraints: List[LinearConstraint] = []
        self._cost = CostFunction(self)

    # -- construction (Problem.h API) ---------------------------------------
    def add_variable(self, vmin: float = -BIG, vmax: float = BIG) -> Variable:
        v = Variable(self, len(self._vars), vmin, vmax)
        self._vars.append(v)
        return v

    def add_linear_constraint(self, cmin: float, cmax: float) -> LinearConstraint:
        c = LinearConstraint(self, cmin, cmax)
        self._constraints.append(c)
        return c

    def cost_function(self) -> CostFunction:
        return self._cost

    def num_variables(self) -> int:
        return len(self._vars)

    def num_linear_constraints(self) -> int:
        return len(self._constraints)

    def variables(self) -> List[Variable]:
        return self._vars

    def reset_problem(self) -> None:
        """Keep variables; drop constraints and zero the cost
        (Problem::resetProblem semantics)."""
        self._constraints.clear()
        self._cost.set_zero()

    # -- lowering + solve -----------------------------------------------------
    def to_qp_batch(self, dtype: torch.dtype = torch.float64) -> QPBatch:
        n = len(self._vars)
        m = len(self._constraints)
        P = np.zeros((n, n))
        for (i, j), cij in self._cost._quad.items():
            # cost convention: sum c_ij x_i x_j -> P = 2 * symmetrized form
            if i == j:
                P[i, i] += 2.0 * cij
            else:
                P[i, j] += cij
                P[j, i] += cij
        q = np.zeros(n)
        for i, ci in self._cost._lin.items():
            q[i] = ci
        A = np.zeros((m + n, n))
        lb = np.empty(m + n)
        ub = np.empty(m + n)
        for r, c in enumerate(self._constraints):
            for i, coeff in c._coeff.items():
                A[r, i] = coeff
            lb[r], ub[r] = c.min, c.max
        for i, v in enumerate(self._vars):  # variable bounds as identity rows
            A[m + i, i] = 1.0
            lb[m + i], ub[m + i] = v.min, v.max
        return QPBatch(*(torch.as_tensor(a, dtype=dtype, device=self.device)
                         for a in (P, q, A, lb, ub)))

    def solve(self, cfg: ADMMConfig = ADMMConfig(iters=800)) -> SolveStatus:
        """Solve and write solution values back into the Variables
        (CPLEXSolver::solve semantics: returns a status, variables carry
        the solution)."""
        qp = self.to_qp_batch()
        sol = solve_batch(qp, cfg)
        z = sol.z.cpu().numpy()
        if not np.all(np.isfinite(z)):
            return SolveStatus.ERROR
        for v, val in zip(self._vars, z):
            v.solution_value = float(val)
        if bool(sol.converged):
            return SolveStatus.OPTIMAL
        # practical mapping: badly violated -> INFEASIBLE, else UNKNOWN
        Ax = qp.A.cpu().numpy() @ z
        viol = np.abs(Ax - np.clip(Ax, qp.lb.cpu().numpy(), qp.ub.cpu().numpy())).max()
        return SolveStatus.INFEASIBLE if viol > 1e-2 else SolveStatus.UNKNOWN
