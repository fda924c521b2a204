"""Batched dense float64 solves of the active-set polish (counterpart of
the part of ``mpc_cbf_tpu/ops/qp/linsolve.py`` that ``polish.py`` calls).

The card has native float64, so the polish's KKT systems go through
PyTorch's batched LU and Cholesky in float64 on whichever device the
tensors live (LAPACK on the CPU, cuSOLVER/cuBLAS/MAGMA on the GPU):

- ``plu_factor`` / ``plu_solve``: LU with partial pivoting
  (``torch.linalg.lu_factor_ex``: no error check, so no host sync) and
  ``torch.linalg.lu_solve``;
- ``spd_solve``: Cholesky (``cholesky_ex``) and two triangular solves. Not
  ``torch.cholesky_solve``: on the card that is MAGMA's batched potrs,
  which mallocs, frees and synchronises in every call.

Left out on purpose (TPU workarounds in the JAX package): the hand-rolled
``_plu_factor_jax`` / ``_plu_solve_jax`` (the TPU rejects an f64 LU),
``mixed_lu_factor`` / ``mixed_lu_solve`` (f32 LU plus f64 refinement, the
TPU polish's route) and ``chol_factor_jax`` / ``chol_solve_jax`` (f64
Cholesky without the TPU's custom calls).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def plu_factor(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched LU with partial pivoting of A [B, k, k]: (LU, pivots) in
    LAPACK's packed form. A pivot below 16 x the dtype's smallest normal is
    replaced by that value with its sign, as the JAX package's portable LU
    guards it, so an exactly singular lane gives huge but finite numbers
    (the polish rejects such runaway lanes) instead of inf."""
    LU, piv, _ = torch.linalg.lu_factor_ex(A, check_errors=False)
    tiny = torch.finfo(A.dtype).tiny * 16
    d = LU.diagonal(dim1=-2, dim2=-1)
    small = d.abs() < tiny
    d.copy_(torch.where(small, torch.where(d < 0, -tiny, torch.full_like(d, tiny)), d))
    return LU, piv


def plu_solve(fac: Tuple[Tensor, Tensor], b: Tensor) -> Tensor:
    """Solve A x = b with a ``plu_factor`` result; b [B, k] -> x [B, k]."""
    LU, piv = fac
    return torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]


def spd_solve(M: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Batched SPD solve M x = b by Cholesky; M [B, k, k], b [B, k].

    A lane whose M is not positive definite comes out NaN, as
    ``jnp.linalg.cholesky`` gives it (``cholesky_ex`` leaves a partly
    filled factor whose solve is finite and meaningless); no host sync."""
    if jitter:
        M = M + jitter * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    L, info = torch.linalg.cholesky_ex(M, check_errors=False)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
