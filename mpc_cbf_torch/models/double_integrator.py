"""Discrete double-integrator dynamics with K-step propagation operators.

Reference parity: ``workspace/lib/model/src/DoubleIntegrator.cpp`` (get_A0
lines 9-27, get_lambda lines 30-51) and ``DoubleIntegratorXYYaw.cpp:9-21``.

Counterpart of ``mpc_cbf_tpu/models/double_integrator.py``: the numpy
operators ``A``, ``B``, ``A0`` and ``Lambda`` are carried over as they are.
They are static, precomputed once in float64 and turned into device tensors
by the operators that use them; ``step`` applies them to a batch of states.
The continuous pair (``f_cont``, ``g_cont``) is written out in
``ops/cbf.py`` (``f_drift``) and not repeated here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpc_cbf_torch.types import State


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator:
    """dim-dimensional discrete double integrator x+ = A x + B u.

    A = [[I, ts*I], [0, I]],  B = [[ts^2/2 * I], [ts * I]]
    (reference DoubleIntegrator.h:79-90, DoubleIntegratorXYYaw.cpp:13-20).
    """

    dim: int
    ts: float

    @property
    def A(self) -> np.ndarray:
        d, ts = self.dim, self.ts
        A = np.eye(2 * d)
        A[:d, d:] = ts * np.eye(d)
        return A

    @property
    def B(self) -> np.ndarray:
        d, ts = self.dim, self.ts
        B = np.zeros((2 * d, d))
        B[:d, :] = 0.5 * ts * ts * np.eye(d)
        B[d:, :] = ts * np.eye(d)
        return B

    def get_A0(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked powers of A: row block k is A^{k+1}.

        Returns (pos, vel), each [dim*K, 2*dim] — the position / velocity
        rows of A^{k+1} (reference get_A0, DoubleIntegrator.cpp:9-27).
        """
        d = self.dim
        pos = np.zeros((d * K, 2 * d))
        vel = np.zeros((d * K, 2 * d))
        prev = np.eye(2 * d)
        for k in range(K):
            new = self.A @ prev
            pos[k * d : (k + 1) * d] = new[:d]
            vel[k * d : (k + 1) * d] = new[d:]
            prev = new
        return pos, vel

    def get_lambda(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """Block-Toeplitz input map Λ: x_k = A^k x0 + Σ_j A^{k-1-j} B u_j.

        Returns (pos, vel), each [dim*K, dim*K]
        (reference get_lambda, DoubleIntegrator.cpp:30-51).
        """
        d = self.dim
        pos = np.zeros((d * K, d * K))
        vel = np.zeros((d * K, d * K))
        prev = np.zeros((2 * d, d * K))
        for k in range(K):
            add_b = np.zeros((2 * d, d * K))
            add_b[:, k * d : (k + 1) * d] = self.B
            new = self.A @ prev + add_b
            pos[k * d : (k + 1) * d] = new[:d]
            vel[k * d : (k + 1) * d] = new[d:]
            prev = new
        return pos, vel

    def step(self, state: State, u: torch.Tensor) -> State:
        """x+ = A x + B u, batched over leading axes.

        (reference applyInput, DoubleIntegrator.cpp:53-63)
        """
        d, ts = self.dim, self.ts
        return State(pos=state.pos + ts * state.vel + (0.5 * ts * ts) * u[..., :d],
                     vel=state.vel + ts * u[..., :d])


def double_integrator_xyyaw(ts: float) -> DoubleIntegrator:
    """The reference's DoubleIntegratorXYYaw: state [px,py,yaw,vx,vy,w],
    u=[ax,ay,alpha] (DoubleIntegratorXYYaw.cpp:9-21)."""
    return DoubleIntegrator(dim=3, ts=ts)
