"""Bernstein-basis operators for Bézier curves, precomputed with numpy.

Reference parity: ``workspace/lib/splines/src/detail/BezierOperations.cpp``
(bernsteinBasis lines 11-50, bernsteinCoefficientMatrix lines 54-121) and
``splines/optimization/BezierQPOperations.cpp`` (Gram cost lines 72-111,
derivative control points lines 232-267).

All of these are functions of *static* curve hyper-parameters (degree, piece
duration, sample times), so they are evaluated once in float64 numpy at
controller build time and copied to the device as constant tensors. The
runtime cost of "evaluate basis" is therefore zero — only the matmuls
basis @ control_points remain.

This is the numpy half of ``mpc_cbf_tpu/ops/bernstein.py`` carried over as
it is (importing it would pull in jax through ``mpc_cbf_tpu/__init__``);
the tensor helpers ``eval_curve``, ``max_derivative_magnitude`` and
``PiecewiseCurve`` evaluate solved curves as one matmul in the dtype and on
the device of the coefficients.

Decision-variable layout per piece (matches BezierQPOperations.cpp:44-68):
per piece the variables are grouped by dimension:
``[x_cp0..x_cp{P-1}, y_cp0.., yaw_cp0..]`` — i.e. column index
``d * num_cp + cp``. Pieces are stacked: piece p occupies columns
``[p*DIM*P, (p+1)*DIM*P)``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def comb(n: int, k: int) -> int:
    return math.comb(n, k) if 0 <= k <= n else 0


def perm(n: int, k: int) -> int:
    return math.perm(n, k) if 0 <= k <= n else 0


def bernstein_basis_row(
    degree: int, max_parameter: float, parameter: float, derivative_degree: int = 0
) -> np.ndarray:
    """Row r with f^(r)(t) = r @ control_points for a 1-D Bézier curve.

    Closed-form r-th-derivative Bernstein row, matching
    BezierOperations.cpp:11-50 exactly (including the max_parameter == 0
    special case).
    """
    result = np.zeros(degree + 1)
    if max_parameter == 0:
        if derivative_degree == 0:
            result[0] = 1.0
        return result
    one_over_a = 1.0 / max_parameter
    for i in range(degree + 1):
        base = 0.0
        mult = 1.0
        j = 0
        while j + derivative_degree <= degree:
            jd = j + derivative_degree
            if jd >= i:
                base += (
                    comb(degree - i, jd - i)
                    * (one_over_a**jd)
                    * perm(jd, derivative_degree)
                    * mult
                    * (1.0 if (jd - i) % 2 == 0 else -1.0)
                )
            mult *= parameter
            j += 1
        result[i] = base * comb(degree, i)
    return result


def bernstein_coefficient_matrix(
    degree: int, max_parameter: float, derivative_degree: int = 0
) -> np.ndarray:
    """Matrix M with f^(r)(t) = [1, t, t^2, ...] @ M.T @ ... — the monomial x
    derivative coefficient matrix of BezierOperations.cpp:54-121.

    Row i / column j entry: coefficient of t^j for control point i, composed
    with the derivative lowering matrix.
    """
    n = degree + 1
    bm = np.zeros((n, n))
    if max_parameter == 0:
        if derivative_degree == 0:
            bm[0, 0] = 1.0
        return bm
    one_over_a = 1.0 / max_parameter
    for i in range(n):
        for j in range(i, n):
            bm[i, j] = (
                comb(degree, i)
                * comb(degree - i, j - i)
                * ((-1.0) ** (j - i))
                * one_over_a**j
            )
    deriv = np.zeros((n, n))
    for j in range(derivative_degree, n):
        deriv[j, j - derivative_degree] = perm(j, derivative_degree)
    return bm @ deriv


def integrated_squared_derivative_gram(
    num_control_points: int, max_parameter: float, derivative_degree: int
) -> np.ndarray:
    """Gram matrix G with ∫0^T ||f^(r)||^2 dt = c' G c per dimension.

    Matches BezierQPOperations::integratedSquaredDerivativeCost
    (BezierQPOperations.cpp:72-111): G = M @ SQI @ M.T with
    SQI_ij = T^(i+j+1) / (i+j+1).
    """
    P = num_control_points
    if derivative_degree > P - 1:
        return np.zeros((P, P))
    M = bernstein_coefficient_matrix(P - 1, max_parameter, derivative_degree)
    i = np.arange(P)[:, None]
    j = np.arange(P)[None, :]
    SQI = max_parameter ** (i + j + 1) / (i + j + 1)
    return M @ SQI @ M.T


def derivative_control_point_rows(
    num_control_points: int, max_parameter: float, derivative_degree: int
) -> np.ndarray:
    """Rows mapping control points -> control points of the r-th derivative.

    Row i gives the i-th control point of the derivative curve as a linear
    combination of the original control points — the finite-difference form
    used by boundingBoxConstraintAll (BezierQPOperations.cpp:232-267).
    Shape: [P - r, P].
    """
    P = num_control_points
    r = derivative_degree
    if r >= P:
        return np.zeros((0, P))
    pw = (1.0 / max_parameter) ** r
    pm = perm(P - 1, r)
    rows = np.zeros((P - r, P))
    for i in range(P - r):
        sign = 1.0
        for j in range(r + 1):
            rows[i, i + r - j] = pw * pm * comb(r, j) * sign
            sign = -sign
    return rows


class PiecewiseBezier:
    """Static description of a piecewise Bézier curve family.

    Holds the piece layout and produces the dense sampling operators used by
    the MPC assembly. Mirrors PiecewiseBezierMPCQPOperations
    (PiecewiseBezierMPCQPOperations.cpp:9-60) + the piecewise generator.
    """

    def __init__(
        self,
        num_pieces: int,
        num_control_points: int,
        piece_max_parameter: float,
        dim: int,
    ):
        self.num_pieces = num_pieces
        self.num_control_points = num_control_points
        self.piece_max_parameter = piece_max_parameter
        self.dim = dim
        self.cumulative = np.cumsum([piece_max_parameter] * num_pieces)
        self.num_decision_variables = num_pieces * dim * num_control_points

    @property
    def max_parameter(self) -> float:
        return float(self.cumulative[-1])

    def piece_index_and_parameter(self, t: float) -> Tuple[int, float]:
        """Matches getPieceIndexAndParameter semantics
        (PiecewiseBezierMPCQPOperations.cpp:193-228): lower_bound on the
        cumulative durations, clamp within the piece."""
        if t < 0 or t > self.cumulative[-1] + 1e-12:
            raise ValueError(f"parameter {t} out of range [0, {self.cumulative[-1]}]")
        idx = int(np.searchsorted(self.cumulative, t, side="left"))
        idx = min(idx, self.num_pieces - 1)
        local = t if idx == 0 else t - self.cumulative[idx - 1]
        local = float(np.clip(local, 0.0, self.piece_max_parameter))
        return idx, local

    def eval_matrix(self, ts: Sequence[float], derivative_degree: int) -> np.ndarray:
        """Dense sampling operator: [len(ts)*dim, n_dec] rows such that
        rows @ z = [f(t_0); f(t_1); ...] stacked per-dim.

        Matches evalSamplingBasisMatrix (PiecewiseBezierMPCQPOperations.cpp:41-60).
        """
        P, D = self.num_control_points, self.dim
        out = np.zeros((len(ts) * D, self.num_decision_variables))
        for k, t in enumerate(ts):
            piece, local = self.piece_index_and_parameter(float(t))
            basis = bernstein_basis_row(P - 1, self.piece_max_parameter, local, derivative_degree)
            col0 = piece * D * P
            for d in range(D):
                out[k * D + d, col0 + d * P : col0 + (d + 1) * P] = basis
        return out

    def piece_eval_row(self, piece: int, local_t: float, derivative_degree: int) -> np.ndarray:
        """[dim, n_dec] rows evaluating a given piece at a local parameter."""
        P, D = self.num_control_points, self.dim
        basis = bernstein_basis_row(P - 1, self.piece_max_parameter, local_t, derivative_degree)
        out = np.zeros((D, self.num_decision_variables))
        col0 = piece * D * P
        for d in range(D):
            out[d, col0 + d * P : col0 + (d + 1) * P] = basis
        return out

    def continuity_rows(self, upto_degree: int) -> np.ndarray:
        """Equality rows enforcing C^{upto_degree-1} continuity between
        consecutive pieces: f_p^(d)(T) - f_{p+1}^(d)(0) = 0 for
        d in [0, upto_degree) (PiecewiseBezierMPCQPGenerator.cpp:182-229).

        Shape: [(num_pieces-1) * upto_degree * dim, n_dec].
        """
        rows = []
        for p in range(self.num_pieces - 1):
            for d in range(upto_degree):
                first = self.piece_eval_row(p, self.piece_max_parameter, d)
                second = self.piece_eval_row(p + 1, 0.0, d)
                rows.append(first - second)
        if not rows:
            return np.zeros((0, self.num_decision_variables))
        return np.concatenate(rows, axis=0)

    def effort_gram(self, derivative_degree: int) -> np.ndarray:
        """Block-diagonal ∫||f^(r)||² Gram over all pieces & dims:
        [n_dec, n_dec]."""
        G = integrated_squared_derivative_gram(
            self.num_control_points, self.piece_max_parameter, derivative_degree
        )
        P, D = self.num_control_points, self.dim
        n = self.num_decision_variables
        out = np.zeros((n, n))
        for p in range(self.num_pieces):
            for d in range(D):
                c0 = p * D * P + d * P
                out[c0 : c0 + P, c0 : c0 + P] = G
        return out

    def control_point_rows_for_piece(self, piece: int) -> np.ndarray:
        """[P, dim, n_dec] selector: entry (cp, d) selects control point cp of
        dimension d of the given piece (used for hyperplane constraints,
        BezierQPOperations.cpp:269-290)."""
        P, D = self.num_control_points, self.dim
        out = np.zeros((P, D, self.num_decision_variables))
        col0 = piece * D * P
        for cp in range(P):
            for d in range(D):
                out[cp, d, col0 + d * P + cp] = 1.0
        return out


def max_derivative_magnitude(
    piecewise: PiecewiseBezier, coeffs: torch.Tensor, derivative_degree: int, step: float = 0.01
) -> torch.Tensor:
    """max_t ||f^(r)(t)|| over a ``step``-spaced scan of the full parameter
    range, matching Bezier::maximumDerivativeMagnitude
    (splines/src/curves/Bezier.cpp:79-97). coeffs: [..., n_dec]; the scan
    grid is static, so this is one matmul and a norm-reduce."""
    ts = np.arange(0.0, piecewise.max_parameter + step / 2, step)
    ts[-1] = min(ts[-1], piecewise.max_parameter)
    samples = eval_curve(piecewise, coeffs, list(ts), derivative_degree)
    return torch.amax(torch.linalg.vector_norm(samples, dim=-1), dim=-1)


def eval_curve(piecewise: PiecewiseBezier, coeffs: torch.Tensor, ts,
               derivative_degree: int = 0) -> torch.Tensor:
    """Evaluate a solved piecewise curve at static times ts.
    coeffs: [..., n_dec]; returns [..., len(ts), dim]."""
    E = torch.as_tensor(piecewise.eval_matrix(list(ts), derivative_degree),
                        dtype=coeffs.dtype, device=coeffs.device)
    flat = coeffs @ E.T                                     # [..., len(ts)*dim]
    return flat.reshape(*flat.shape[:-1], len(ts), piecewise.dim)


class PiecewiseCurve:
    """A solved curve: coefficients bound to their PiecewiseBezier family,
    the counterpart of splines::SingleParameterPiecewiseCurve
    (curves/SingleParameterPiecewiseCurve.h:13-63: eval(t, derivative),
    max_parameter) and splines::Bezier::maximumDerivativeMagnitude."""

    def __init__(self, piecewise: PiecewiseBezier, coeffs: torch.Tensor):
        self.pw = piecewise
        self.coeffs = coeffs

    @property
    def max_parameter(self) -> float:
        return self.pw.max_parameter

    def eval(self, t: float, derivative_degree: int = 0) -> torch.Tensor:
        """f^(r)(t) -> [..., dim], t clamped to [0, max_parameter] as the
        reference callers do."""
        t = float(np.clip(t, 0.0, self.pw.max_parameter))
        return eval_curve(self.pw, self.coeffs, [t], derivative_degree)[..., 0, :]

    def max_derivative_magnitude(self, derivative_degree: int, step: float = 0.01):
        return max_derivative_magnitude(self.pw, self.coeffs, derivative_degree, step)
