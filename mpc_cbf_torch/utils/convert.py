"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's arrays cross over as numpy (``np.asarray(jax_array)``);
nothing here imports jax. Used to feed the same problem and the same warm
start to both packages:
- ``set_structured_constants``: a StructuredQPOperator's constants (D,
  E_s, gamma, Pb, A_sb and each phase's Ms_inv, rho_s and rho_d, and the
  float64 M_s = Ms_inv^-1 of the C form);
- ``state_from_numpy``: a ``State``;
- ``warm_start_from_numpy`` / ``warm_start_to_numpy``: the warm primal and
  the warm duals (ys, yd) of an ``IMPCResult``, both ways (None duals for
  the IPM family, which keeps none);
- ``ipm_state_from_numpy`` / ``ipm_state_to_numpy``: the interior state
  (v, t, zl, zu) of an ``IPMSolution``, both ways, so one package's f32
  entry can feed the other's f64 tail;
- ``qp_batch_from_numpy`` / ``qp_solution_to_numpy``: a dense ``QPBatch``
  in, a ``QPSolution`` out (z and y also serve as the other package's warm
  start);
- ``pf_state_from_numpy`` / ``pf_state_to_numpy``: a particle bank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mpc_cbf_torch.types import QPBatch, QPSolution, State
from mpc_cbf_torch.controllers.mpc_cbf import IMPCResult
from mpc_cbf_torch.estimation.particle_filter import PFState
from mpc_cbf_torch.ops.qp.structured import StructuredQPOperator


def to_tensor(a, *, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def set_structured_constants(op: StructuredQPOperator, *, D, E_s, gamma: float, Pb, A_sb,
                             phases: Sequence[Tuple[int, object, object, float]]) -> None:
    """Overwrite op's equilibration and phase constants with the JAX
    operator's (``phases``: its list of (iters, Ms_inv, rho_s, rho_d)).
    Shapes and the phase iteration counts must match op's. Each phase's
    float64 M_s (the C form's, which the JAX package does not keep) becomes
    the inverse of the JAX operator's Ms_inv, so that the port's C =
    (M_s + A_d' R A_d)^-1 is the JAX Woodbury solve with the same Ms_inv."""
    if len(phases) != len(op.phases):
        raise ValueError(f"{len(phases)} phases given, operator has {len(op.phases)}")
    t = op._tensor
    new = dict(D=t(D), E_s=t(E_s), Pb=t(Pb), A_sb=t(A_sb))
    for name, val in new.items():
        if val.shape != getattr(op, name).shape:
            raise ValueError(f"{name}: shape {tuple(val.shape)}, operator has "
                             f"{tuple(getattr(op, name).shape)}")
    new_phases = []
    for (n_it, Ms_inv, rho_s, rho_d), (own_it, *_) in zip(phases, op.phases):
        if int(n_it) != own_it:
            raise ValueError(f"phase of {n_it} iterations, operator runs {own_it}")
        new_phases.append((own_it, t(Ms_inv), t(rho_s), float(rho_d)))
    for name, val in new.items():
        setattr(op, name, val)
    op.gamma = float(gamma)
    op.phases = new_phases
    op.M_s = [torch.linalg.inv(torch.as_tensor(np.array(M, np.float64), device=op.device))
              for _, M, _, _ in phases]
    _, op.Ms_inv, op.rho_s, op.rho_d = op.phases[0]


def state_from_numpy(pos, vel, *, device, dtype) -> State:
    return State(pos=to_tensor(pos, device=device, dtype=dtype),
                 vel=to_tensor(vel, device=device, dtype=dtype))


def warm_start_from_numpy(coeffs, ys, yd, n: int, *, device, dtype
                          ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """(warm [B, n], warm_duals) for ``StructuredIMPC.optimize_batch`` from
    an IMPCResult's coeffs [B, n_dec] (slack columns start at 0) and
    unscaled duals ys [B, m_s], yd [B, m_d] (None: no dual warm start)."""
    c = to_tensor(coeffs, device=device, dtype=dtype)
    warm = torch.zeros((c.shape[0], n), dtype=dtype, device=device)
    warm[:, : c.shape[1]] = c
    if ys is None:
        return warm, None
    return warm, (to_tensor(ys, device=device, dtype=dtype),
                  to_tensor(yd, device=device, dtype=dtype))


def _numpy(a: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if a is None else a.detach().cpu().numpy()


def warm_start_to_numpy(res: IMPCResult, n: int
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """(warm [B, n], ys, yd) as numpy from the port's IMPCResult, in the
    form the JAX package's ``optimize_batch(warm=..., warm_duals=(ys, yd))``
    takes. ys and yd are None for an IPM-family result."""
    coeffs = _numpy(res.coeffs)
    warm = np.zeros((coeffs.shape[0], n), coeffs.dtype)
    warm[:, : coeffs.shape[1]] = coeffs
    return warm, _numpy(res.ys), _numpy(res.yd)


def ipm_state_from_numpy(state, *, device, dtype) -> Tuple[torch.Tensor, ...]:
    """An IPM interior state (v [B, nz], t [B, m], zl [B, m], zu [B, m]) as
    tensors, for ``StructuredIPM.solve(..., state0=...)``."""
    return tuple(to_tensor(a, device=device, dtype=dtype) for a in state)


def ipm_state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    """The port's ``IPMSolution.state`` as numpy, in the form the JAX
    package's ``StructuredIPM.solve(..., state0=...)`` takes."""
    return tuple(_numpy(a) for a in state)


def qp_batch_from_numpy(P, q, A, lb, ub, *, device, dtype) -> QPBatch:
    """A dense QP batch from the five arrays of the JAX package's QPBatch."""
    return QPBatch(*(to_tensor(a, device=device, dtype=dtype) for a in (P, q, A, lb, ub)))


def qp_solution_to_numpy(sol: QPSolution) -> Tuple[np.ndarray, ...]:
    """(z, y, pri_res, dua_res, converged) as numpy."""
    return tuple(_numpy(a) for a in sol)


def pf_state_from_numpy(particles, weights, *, device, dtype) -> PFState:
    return PFState(particles=to_tensor(particles, device=device, dtype=dtype),
                   weights=to_tensor(weights, device=device, dtype=dtype))


def pf_state_to_numpy(st: PFState) -> Tuple[np.ndarray, np.ndarray]:
    return _numpy(st.particles), _numpy(st.weights)
