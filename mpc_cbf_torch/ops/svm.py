"""Hard-margin SVM separating hyperplanes via the batched dense QP solver
(counterpart of ``mpc_cbf_tpu/ops/svm.py``).

Reference parity: ``separating_hyperplanes/src/SVM.cpp:9-79``: the
max-margin hyperplane between two point sets,
    min ||w||^2  s.t.  w.x_i + b <= -1 (first set), w.x_j + b >= +1 (second),
solved there with CPLEX. Here the same QP runs through the batched ADMM
(``ops/qp/admm.py::solve_batch``); leading batch axes of the point sets
become lanes of one solve.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpc_cbf_torch.types import BIG, QPBatch
from mpc_cbf_torch.ops.qp.admm import ADMMConfig, solve_batch


def hard_margin_svm(first_points: torch.Tensor, second_points: torch.Tensor,
                    cfg: ADMMConfig = ADMMConfig(iters=1000)) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normal [..., dim], offset [...]) with normal.x + offset <= -1 on the
    first set. first_points [..., N1, dim], second_points [..., N2, dim]."""
    dim = first_points.shape[-1]
    dt, dev = first_points.dtype, first_points.device
    # cost: min w'w (z'Qz convention with Q = diag(1...1, 0) -> P = 2Q)
    P = 2.0 * torch.diag(torch.cat([torch.ones(dim, dtype=dt, device=dev),
                                    torch.zeros(1, dtype=dt, device=dev)]))
    ones = lambda pts: torch.ones((*pts.shape[:-1], 1), dtype=dt, device=dev)
    A = torch.cat([torch.cat([first_points, ones(first_points)], dim=-1),
                   torch.cat([second_points, ones(second_points)], dim=-1)], dim=-2)
    m1, m2 = first_points.shape[-2], second_points.shape[-2]
    full = lambda k, v: torch.full((k,), v, dtype=dt, device=dev)
    batch = A.shape[:-2]
    lb = torch.cat([full(m1, -BIG), full(m2, 1.0)]).expand(*batch, m1 + m2)
    ub = torch.cat([full(m1, -1.0), full(m2, BIG)]).expand(*batch, m1 + m2)
    q = torch.zeros((*batch, dim + 1), dtype=dt, device=dev)
    sol = solve_batch(QPBatch(P=P, q=q, A=A, lb=lb, ub=ub), cfg)
    return sol.z[..., :dim], sol.z[..., dim]
