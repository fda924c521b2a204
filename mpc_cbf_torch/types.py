"""Core types (counterpart of ``mpc_cbf_tpu/types.py``).

``State`` is the reference's ``model::State`` (``DoubleIntegrator.h:19-27``)
as a pair of tensors with arbitrary leading batch axes; ``QPBatch`` and
``QPSolution`` are the dense solver's problem and answer.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass
class State:
    """Double-integrator state: position-like block and velocity-like block.

    pos: [..., DIM]  (for DIM=3 the layout is [px, py, yaw])
    vel: [..., DIM]  ([vx, vy, omega])
    """

    pos: torch.Tensor
    vel: torch.Tensor

    @property
    def stacked(self) -> torch.Tensor:
        """[..., 2*DIM] concatenation [pos, vel] (reference x0 layout)."""
        return torch.cat([self.pos, self.vel], dim=-1)

    @classmethod
    def from_stacked(cls, x: torch.Tensor) -> "State":
        dim = x.shape[-1] // 2
        return cls(pos=x[..., :dim], vel=x[..., dim:])


class QPBatch(NamedTuple):
    """A batch of dense box-and-row constrained QPs.

    minimize    0.5 z' P z + q' z
    subject to  lb <= A z <= ub          (row constraints; equality if lb==ub)

    Shapes (leading batch axes allowed):
      P:  [..., n, n]   symmetric PSD
      q:  [..., n]
      A:  [..., m, n]   zero rows = padding (masked out by lb=-BIG, ub=+BIG)
      lb: [..., m]
      ub: [..., m]

    Variable box bounds are expected to be encoded as identity rows in A so
    that the solver sees a single uniform projection (see ops/qp/canon.py).
    """

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor

    @property
    def n(self) -> int:
        return self.q.shape[-1]

    @property
    def m(self) -> int:
        return self.lb.shape[-1]


class QPSolution(NamedTuple):
    """Solution of a QPBatch solve.

    z:        [..., n] primal solution
    y:        [..., m] dual solution (row constraints)
    pri_res:  [...]    final primal residual (inf-norm)
    dua_res:  [...]    final dual residual (inf-norm)
    converged:[...]    bool, residuals under tolerance
    """

    z: torch.Tensor
    y: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    converged: torch.Tensor


# A sentinel "infinite" bound. Large but well inside float32 range so that
# arithmetic (e.g. ub + slack) stays finite.
BIG = 1e20
