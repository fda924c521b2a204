"""Piecewise Bézier curves and the double integrator, written from their
definitions with numpy polynomials (float64).

A curve has ``pieces`` pieces of ``cps`` control points in each of ``dim``
dimensions, each piece lasting ``T`` seconds. The decision vector is laid
out piece by piece, then dimension by dimension, then control point:
z[(p * dim + d) * cps + i]. A time on a boundary between two pieces
belongs to the earlier piece.
"""

from __future__ import annotations

from math import comb

import numpy as np
from numpy.polynomial import Polynomial


class Curve:
    def __init__(self, pieces: int, cps: int, T: float, dim: int):
        self.pieces, self.cps, self.T, self.dim = pieces, cps, float(T), dim
        self.n = pieces * cps * dim
        deg = cps - 1
        s = Polynomial([0.0, 1.0 / self.T])              # s = t / T
        # Bernstein polynomials of the piece, as polynomials in local time t
        self.basis = [comb(deg, i) * s ** i * (1 - s) ** (deg - i) for i in range(cps)]

    @property
    def duration(self) -> float:
        return self.pieces * self.T

    def _piece(self, t: float):
        if t < -1e-12 or t > self.duration + 1e-12:
            raise ValueError(f"time {t} outside the curve")
        p = min(max(int(np.ceil(t / self.T - 1e-12)) - 1, 0), self.pieces - 1)
        return p, min(max(t - p * self.T, 0.0), self.T)

    def piece_row(self, p: int, t_local: float, der: int) -> np.ndarray:
        """[dim, n]: the der-th derivative of piece p at local time t_local."""
        vals = np.array([b.deriv(der)(t_local) if der else b(t_local) for b in self.basis])
        out = np.zeros((self.dim, self.n))
        for d in range(self.dim):
            c0 = (p * self.dim + d) * self.cps
            out[d, c0:c0 + self.cps] = vals
        return out

    def sample(self, ts, der: int) -> np.ndarray:
        """[len(ts) * dim, n]: the der-th derivative at each time, stacked."""
        return np.concatenate([self.piece_row(*self._piece(float(t)), der) for t in ts])

    def continuity(self, degrees: int) -> np.ndarray:
        """Rows holding derivatives 0 .. degrees-1 equal across each joint."""
        rows = [self.piece_row(p, self.T, d) - self.piece_row(p + 1, 0.0, d)
                for p in range(self.pieces - 1) for d in range(degrees)]
        return np.concatenate(rows) if rows else np.zeros((0, self.n))

    def effort(self, der: int) -> np.ndarray:
        """[n, n] G with z' G z = the integral of |der-th derivative|^2 over
        the whole curve."""
        g = np.zeros((self.cps, self.cps))
        for i, bi in enumerate(self.basis):
            for j, bj in enumerate(self.basis):
                prod = (bi.deriv(der) * bj.deriv(der)).integ()
                g[i, j] = prod(self.T) - prod(0.0)
        out = np.zeros((self.n, self.n))
        for p in range(self.pieces):
            for d in range(self.dim):
                c0 = (p * self.dim + d) * self.cps
                out[c0:c0 + self.cps, c0:c0 + self.cps] = g
        return out

    def control_point(self, p: int, i: int) -> np.ndarray:
        """[dim, n]: control point i of piece p."""
        out = np.zeros((self.dim, self.n))
        for d in range(self.dim):
            out[d, (p * self.dim + d) * self.cps + i] = 1.0
        return out


def integrator_rollout(dim: int, dt: float, K: int):
    """(F [dim*K, 2*dim], G [dim*K, dim*K]): the positions after steps
    1..K of x+ = x + dt v + dt^2/2 u, v+ = v + dt u, from state [p, v] and
    inputs u_0..u_{K-1}: pos = F [p; v] + G u."""
    F = np.zeros((dim * K, 2 * dim))
    G = np.zeros((dim * K, dim * K))
    eye = np.eye(dim)
    for k in range(1, K + 1):
        r = slice((k - 1) * dim, k * dim)
        F[r, :dim] = eye
        F[r, dim:] = k * dt * eye
        for j in range(k):                     # u_j acts for k - j steps
            G[r, j * dim:(j + 1) * dim] = (dt * dt * (2 * (k - j) - 1) / 2.0) * eye
    return F, G
